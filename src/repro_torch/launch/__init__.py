"""Launch layer: the serving entry point (port of ``repro/launch``)."""
