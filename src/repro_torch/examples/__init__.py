"""The reference's ``examples/`` on the port's entry points (run each with
``python -m repro_torch.examples.<name>``; ``--device cpu`` off the card,
``--smoke`` at a small size). Each prints one JSON result line last."""
