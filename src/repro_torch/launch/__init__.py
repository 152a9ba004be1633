"""Launch layer: the serving entry point and the roofline constants
(port of ``repro/launch``)."""
