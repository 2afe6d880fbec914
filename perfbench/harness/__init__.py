"""The benchmark's general machinery: finding a cell's files by name,
recording spans and launches in a traced run, and reading the profiler's
device trace."""
