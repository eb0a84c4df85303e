#!/usr/bin/env python
"""Phase profile of the port's local stream join (counterpart of
scripts/profile_stream.py).

An inner join of two tables of 2^rows_log2 rows on one device
(``default_rng(0)``: an int32 key uniform in [0, n) and a float32
payload a side, the JAX script's draws), taken apart into the stream
route's phases. Each is the best of 3 runs after one warm-up, each ending
in ``torch.cuda.synchronize()``:

* ``keybits_sort_s``: the key bits and the stream sort, the payload
  lanes riding along (``join.stream_plan_inputs``);
* ``plan_kernel_s``: K3 alone on the sorted stream;
* ``plan_s``: both, as ``join.plan_program_stream`` runs them (the JAX
  script's "plan");
* ``materialize_s``: K4 and the output lanes and gathers
  (``join.materialize_program_stream``, the JAX script's
  "materialize"); ``expand_s``: K4 alone (its "expand");
  ``gathers_s``: the difference, the lane unpack and the gathers of the
  columns that do not ride K4;
* ``join_wall_s``: the whole ``Table.join``.

``n_out`` is K3's output row count, checked against numpy, and ``cap_e``
the expansion capacity K4 fills.

    python scripts/torch_port/profile_stream.py [rows_log2=24]
        [--device cuda|cpu] [--out PATH]

The last stdout line is the JSON summary, with the kernel launches; a
file is written only to ``--out``.
"""
import numpy as np

import drill_common


def join_tables(ct, ctx, n: int):
    """The JAX script's draws as two tables, and numpy's inner-join row
    count."""
    rng = np.random.default_rng(0)
    lk = rng.integers(0, n, n).astype(np.int32)
    lv = rng.normal(size=n).astype(np.float32)
    rk = rng.integers(0, n, n).astype(np.int32)
    rv = rng.normal(size=n).astype(np.float32)
    left = ct.Table.from_pydict(ctx, {"k": lk, "v": lv})
    right = ct.Table.from_pydict(ctx, {"k": rk, "w": rv})
    expect = int((np.bincount(lk, minlength=n).astype(np.int64)
                  * np.bincount(rk, minlength=n)).sum())
    return left, right, expect


def stream_args(left, right):
    """The local join's stream-route inputs (data/table.py
    ``_join_once``): a function computing the key bits and the sort
    (K3's keyword arguments), and the payload lanes."""
    from cylon_tpu_torch.data import table as T
    from cylon_tpu_torch.ops import join as J

    jt = J.JoinType.INNER
    ldat, lval, _ls = T.lane_payload(left._columns)
    rdat, rval, _rs = T.lane_payload(right._columns)
    ldat, lval, rdat, rval = (T._rows(x) for x in (ldat, lval, rdat, rval))
    a_desc, b_desc = J.plan_lane_descs(ldat, lval, rdat, rval, jt)
    payload = (ldat, lval, rdat, rval)

    def keybits_sort():
        lbits, lkv = J.key_bits(T._rows([left._columns[0].data]), (None,))
        rbits, rkv = J.key_bits(T._rows([right._columns[0].data]), (None,))
        return J.stream_plan_inputs(lbits, lkv, None, rbits, rkv, None,
                                    *payload, jt, a_desc, b_desc)

    return keybits_sort, payload, (a_desc, b_desc)


def main(argv=None) -> dict:
    args = drill_common.tool_parser(__doc__.split("\n")[0], 24,
                                    "the rows a side").parse_args(argv)
    device = drill_common.device_of(args.device)
    launches0 = drill_common.launches()

    import cylon_tpu_torch as ct
    from cylon_tpu_torch.ops import join as J
    from cylon_tpu_torch.ops import kernels as K

    ctx = ct.CylonContext.Init(device=device)
    n = 1 << args.rows_log2
    left, right, expect = join_tables(ct, ctx, n)
    keybits_sort, payload, (a_desc, b_desc) = stream_args(left, right)
    jt = J.JoinType.INNER

    def best(fn):
        return drill_common.best_of(fn, device)

    res = {"n_rows": n, "backend": device.type,
           "device": drill_common.card_name(device)}
    res["keybits_sort_s"] = best(keybits_sort)
    kw = keybits_sort()
    res["plan_kernel_s"] = best(lambda: K.join_plan_stream(**kw))
    res["plan_s"] = best(lambda: K.join_plan_stream(**keybits_sort()))
    counts, a_s, b_s = K.join_plan_stream(**kw)
    res["n_out"] = int(counts[0, 0])
    if res["n_out"] != expect:
        raise AssertionError(f"K3 counts {res['n_out']} output rows, numpy "
                             f"{expect}")
    cap_e = J.stream_expand_capacity(res["n_out"],
                                     J.stream_block_rows(n, n))
    res["cap_e"] = cap_e
    res["materialize_s"] = best(lambda: J.materialize_program_stream(
        counts, a_s, b_s, *payload, jt, cap_e, a_desc=a_desc,
        b_desc=b_desc))
    res["expand_s"] = best(lambda: K.join_expand_stream(counts, a_s, b_s,
                                                        cap_e))
    res["gathers_s"] = max(res["materialize_s"] - res["expand_s"], 0.0)

    def join():
        return left.join(right, "inner", on="k")

    res["join_wall_s"] = best(join)
    res["rows_out"] = join().row_count
    if res["rows_out"] != expect:
        raise AssertionError(f"the join returned {res['rows_out']} rows, "
                             f"numpy counts {expect}")
    return drill_common.finish(res, args.out, launches0)


if __name__ == "__main__":
    main()
