"""Cost model, roofline and breakdown of what one rank runs (the port of ``repro/analysis``)."""
