"""Data generators, one file per kind, named by a configuration's
``generator.kind``; each has ``make(cfg, seed, device, n_queries)``
returning (rows, queries) float32 tensors on the device."""
