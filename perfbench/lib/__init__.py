"""The harness: loading a cell from its files, the runners of each kind of
traffic, the trace reduction, the roofline table and the output checks."""
