"""The benchmark's own library: where each cell's files are, the frozen
pair generators, the RANSAC draws, the trace reduction, the peaks and the
operation counts, and the comparison that decides `correct`.  Nothing here
imports the program under test; `run.py` hands its outputs in."""
