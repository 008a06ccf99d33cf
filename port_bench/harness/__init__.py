"""The general part of the benchmark: finding a cell's pieces by name,
making its inputs from the seed, running the window, reading the trace
and deciding `correct`."""
