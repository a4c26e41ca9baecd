"""Raw-data substrate: formats, synthetic datasets, chunk store."""
