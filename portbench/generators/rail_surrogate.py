"""``rail_surrogate``: the seeded 2-D heat-equation surrogate of the Rail
pencils (`pbench.surrogate`, a frozen copy of the port's generator) at the
configuration's ``n``, ``m`` and ``q``: SciPy CSR ``E``, ``A``; numpy
``B (n, m)``, ``C (q, n)``.  Only ``E``'s diagonal depends on the seed."""

from pbench import surrogate


def build(config: dict, seed: int) -> dict:
    E, A, B, C = surrogate.rail_surrogate(config["n"], m=config["m"], q=config["q"], seed=seed)
    return {"E": E, "A": A, "B": B, "C": C}
