"""The benchmark's yardstick: data, radius rule, traffic, the plain
reference, the comparison, the window, the trace and the cost counts.
Nothing here imports the program except ``cell.py``, which drives it."""
