"""The general parts of the benchmark: finding a cell's files, making its
inputs, the window, the trace, the correctness check."""
