"""The general parts of the benchmark: loading what ``BENCHMARK.json``
names, making the inputs, driving the traffic, reading the trace,
counting the work, and deciding ``correct``."""
