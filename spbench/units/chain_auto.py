"""Unit kind ``chain_auto``: the chain A^2 .. A^(steps + 1) on the route
that the program's chain router picks, ``ops.hybrid.choose_strategy(A,
steps)``.

The route's driver is the unit file ``route_<route>.py`` beside this one.
A route without one fails the run by name, so a change of the router's
choice shows as a failed run and not as another cell under the same name.
Traffic keys: ``steps``.
"""

from __future__ import annotations

from sparsetpu_torch.csr import HostCSR
from sparsetpu_torch.ops import hybrid


def setup(ctx):
    rows, cols, vals, n = ctx.coo
    host = HostCSR.from_coo(rows, cols, vals, n, n, ctx.config["semiring"])
    route = hybrid.choose_strategy(host, steps=ctx.traffic["steps"])
    try:
        driver = ctx.load("units", f"route_{route}")
    except FileNotFoundError:
        raise RuntimeError(f"choose_strategy routes the chain to {route!r}, and spbench has "
                           f"no driver for that route (units/route_{route}.py)") from None
    unit = driver.setup(ctx, host)
    unit.info["route"] = route
    return unit
