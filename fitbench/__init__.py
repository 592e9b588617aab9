"""The port's benchmark: time to a fitted model on the card (``run.py``)."""
