"""Traffic generators: frozen copies of the program's sound generators,
driven by the parameters of a mix file and the run's seed."""
