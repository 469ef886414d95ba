"""The yardstick of the port's benchmark: what later changes to the program
cannot move.  Loading the benchmark's files by name (``spec``), the traffic
generator (``traffic``), the window and percentile arithmetic (``stats``,
``window``), the FLOP and byte counts (``counts``), the card's peaks
(``peaks``), the weights drawn from the seed (``weights``), the reduction of
the profiler's raw events (``trace``) and the comparison that decides
``correct`` (``check``).  Nothing here imports the program.
"""
