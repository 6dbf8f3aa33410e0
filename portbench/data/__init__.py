"""One module per data kind that a configuration names (``data.kind``).

Every module gives ``make(shape, data, seed, k, device)``: the k-th input of
a run's pool, of ``shape``, from the configuration's ``data`` parameters and
the seed, made on ``device``.
"""
