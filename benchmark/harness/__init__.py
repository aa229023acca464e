"""The benchmark's own code: finding a cell's files by name (cell.py),
the host ranges and timers it puts around the calls into the program
(spans.py), the device trace and its reduction (trace.py), the work and
peaks that rooflines are read against (work.py) and the result line
(contract.py)."""
