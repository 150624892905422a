"""Seeded data of the configurations' shapes, one module per data set,
found by the name in a configuration's ``data`` key: ``<name>.py`` defines
``make(cfg, gen, device)``, which returns (inputs (N, D), targets (N,)) in
float64 on ``device``, every draw from the one ``torch.Generator``."""
