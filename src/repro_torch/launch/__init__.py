"""Launch layer: the serving and training entry points and the roofline
constants (port of ``repro/launch``)."""
