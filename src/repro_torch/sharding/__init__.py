"""Process groups of the multi-rank paths (``compat``; the port's analogue
of ``repro.sharding.compat``)."""
