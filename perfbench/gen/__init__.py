"""Traffic and genome generators of the benchmark (numpy, from a seed)."""
