"""The benchmark's yardstick: window arithmetic, timers, the reading of
the profiler's trace, roofline counts and the comparison helpers. Nothing
here imports the program."""
