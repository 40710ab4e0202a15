"""The one general traffic generator: each client's requests from a
traffic file (``traffic/<name>.json``) and the seed.

A traffic file holds:

* ``clients``: closed-loop clients, each on its own keep-alive
  connection, each sending its next request once the last is answered;
* ``order``: ``cycle`` (the templates in turn, client k starting at the
  k-th), ``shuffled_cycle`` (each round of the templates in a seeded
  order) or ``random`` (each request's template drawn alike from the
  seed);
* ``warm_requests``: requests each client sends before the window, from
  a stream of their own;
* ``templates``: ``{"name", "pql"}``, the body with ``{draw}`` fields;
* ``draws``: named values drawn for every request, in order, by a law:
  ``uniform_int`` (``lo``..``hi``), ``choice`` (``values``), ``zipf``
  (``values`` ranked most frequent first, ``theta``; the YCSB sampler of
  ``pilosa_tpu_torch/loadgen/workload.py``), ``offset`` (draw ``of`` plus
  ``by``); ``distinct_from`` redraws until it differs from a draw before
  it.

The same seed, client and phase give the same requests; another seed
gives the same templates in other orders with other draws.
"""

from __future__ import annotations

import numpy as np

WARM, WINDOW = 0, 1


class Zipf:
    """Rank sampler over ``[0, n)``: rank r with probability proportional
    to 1/(r+1)^theta, by inverse CDF (loadgen's sampler)."""

    def __init__(self, n: int, theta: float):
        cdf = np.arange(1, n + 1, dtype=np.float64)
        np.power(cdf, -theta, out=cdf)
        np.cumsum(cdf, out=cdf)
        cdf /= cdf[-1]
        self._cdf = cdf

    def sample(self, rng: np.random.Generator) -> int:
        return int(np.searchsorted(self._cdf, rng.random(), side="right"))


class Plan:
    """One client's requests in one phase: ``next()`` gives
    ``(template name, PQL body)``."""

    def __init__(self, spec: dict, seed: int, client: int, phase: int):
        self.spec = spec
        self.rng = np.random.default_rng([int(seed) % (1 << 64), client, phase])
        self.templates = spec["templates"]
        self.zipf = {k: Zipf(len(d["values"]), d["theta"])
                     for k, d in spec.get("draws", {}).items() if d["law"] == "zipf"}
        self._round: list[int] = []
        self._first = client % len(self.templates)

    def _draw(self, name: str, law: dict, got: dict):
        rng = self.rng
        for _ in range(1000):
            if law["law"] == "uniform_int":
                v = int(rng.integers(law["lo"], law["hi"] + 1))
            elif law["law"] == "choice":
                v = law["values"][int(rng.integers(len(law["values"])))]
            elif law["law"] == "zipf":
                v = law["values"][self.zipf[name].sample(rng)]
            elif law["law"] == "offset":
                v = got[law["of"]] + law["by"]
            else:
                raise ValueError(f"unknown law {law['law']!r}")
            if "distinct_from" not in law or v != got[law["distinct_from"]]:
                return v
        raise ValueError(f"draw {name!r} never differs from {law['distinct_from']!r}")

    def _template(self) -> dict:
        order = self.spec.get("order", "cycle")
        n = len(self.templates)
        if order == "random":
            return self.templates[int(self.rng.integers(n))]
        if not self._round:
            self._round = (list(self.rng.permutation(n)) if order == "shuffled_cycle"
                           else [(self._first + i) % n for i in range(n)])
        return self.templates[self._round.pop(0)]

    def next(self) -> tuple[str, str]:
        t = self._template()
        got: dict = {}
        for name, law in self.spec.get("draws", {}).items():
            got[name] = self._draw(name, law, got)
        return t["name"], t["pql"].format(**got)
