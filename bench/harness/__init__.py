"""The general parts of the benchmark: the spec, the run, the trace
reader, the comparison and the closed loop."""
