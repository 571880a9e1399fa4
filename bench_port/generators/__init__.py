"""Traffic generators: each reads the parameters of a mix
(`traffic/<mix>.json`) and makes its requests from the run's seed."""
