"""Roofline accounting on the H100 (``hlo``); port of ``repro/roofline``."""
