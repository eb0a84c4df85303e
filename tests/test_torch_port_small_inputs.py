"""cylon_tpu_torch's distributed joins at world 8 and set ops at world 4
and 8 on small and empty inputs (the compact exchange route's inputs)
against cylon_tpu's on the virtual CPU mesh, on both partition routes:
equal as bitwise row multisets. The cases and the cached JAX results
are those of tests/test_torch_port_compact_exchange.py; a file of their
own keeps each file's time under a minute."""
import pytest

import cylon_tpu_torch as tct

from test_torch_port_compact_exchange import (SMALL, _jax_small,
                                               _small_arrays,
                                               check_small_join, route,
                                               tctxs)
from test_torch_port_join import assert_rows_bit_equal

__all__ = ["route", "tctxs"]


@pytest.mark.parametrize("case", list(SMALL))
@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
@pytest.mark.parametrize("route", ["plan", "kernel"], indirect=True)
def test_small_distributed_join_world_8(request, tctxs, case, how, route):
    check_small_join(request, tctxs, 8, case, how, route)


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("case", list(SMALL))
@pytest.mark.parametrize("op", ["union", "subtract", "intersect"])
@pytest.mark.parametrize("route", ["plan", "kernel"], indirect=True)
def test_small_distributed_set_op(request, tctxs, world, case, op, route):
    la, ra = _small_arrays(case)
    tl = tct.Table.from_pydict(tctxs[world], la)
    tr = tct.Table.from_pydict(tctxs[world], ra)
    got = getattr(tl, f"distributed_{op}")(tr).to_pandas()
    assert_rows_bit_equal(got, _jax_small(request, world, case, op),
                          msg=f"{case} world {world} {op} {route}")
