"""Entry points: step functions (``steps.py``) and the serving CLI (``serve.py``)."""
