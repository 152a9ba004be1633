"""Launch layer: the serving and training entry points, the multi-pod
dry run and the roofline terms (port of ``repro/launch``)."""
