"""Optimizers for the LM train step (``optimizers``)."""
