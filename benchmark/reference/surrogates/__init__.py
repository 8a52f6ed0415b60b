"""The learner's pairwise surrogates l(d) of a score difference d, one
module a surrogate, found by the traffic's ``surrogate`` name. Each has
``terms(d) -> (l(d), l'(d))``, elementwise in d's dtype; it may take d's
storage for its own."""

import importlib


def get(name: str):
    return importlib.import_module(f"{__name__}.{name}")
