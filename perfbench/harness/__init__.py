"""The general part of the benchmark: finding a cell's files, timing
its window, tracing it, and printing its result."""
