#!/usr/bin/env python
"""Phase profile of the port's single-device join, with micro-benchmarks
of the candidate gathers and scatters (counterpart of
scripts/profile_join.py).

The join of scripts/torch_port/profile_stream.py (two tables of
2^rows_log2 rows, ``default_rng(0)``), whose single-device route is the
stream route (sort, K3, K4): ``plan_s`` (key bits, sort and K3),
``materialize_s`` (K4, lane unpack and gathers) and ``expand_s`` (K4
alone); ``n_primary`` the output rows, checked against numpy, and ``cap``
the expansion capacity. Then the micro-benchmarks, on the stream sort's
own permutation of the 2n concatenated rows:

* ``gather_1col_s``: one int32 lane gathered by the permutation;
  ``gather_4x1col_s``: four lanes, one gather each (what the stream
  sort does with the key bits, the tag and two payload lanes);
* ``gather_packed4_s`` / ``gather_packed2_s``: the same rows as one
  gather of a packed [2n, 4] / [2n, 2] int32 tensor (the packing itself
  not timed): the fused-lane gather that a first ``perf_opt`` would
  build;
* ``scatter_1col_s`` / ``scatter_packed2_s``: a scatter of one int32
  column / of a packed [n, 2] tensor by a random permutation of n;
* ``sort_fused_s``: the stream sort's one 64-bit sort of (key bits, tag)
  over 2n rows; ``cumsum_s``: an int32 cumsum over 2n rows.

Each is the best of 3 runs after one warm-up, each ending in
``torch.cuda.synchronize()``.

    python scripts/torch_port/profile_join.py [rows_log2=24]
        [--device cuda|cpu] [--out PATH]

The last stdout line is the JSON summary, with the kernel launches; a
file is written only to ``--out``.
"""
import numpy as np

import drill_common
import profile_stream


def main(argv=None) -> dict:
    args = drill_common.tool_parser(__doc__.split("\n")[0], 24,
                                    "the rows a side").parse_args(argv)
    device = drill_common.device_of(args.device)
    launches0 = drill_common.launches()

    import torch

    import cylon_tpu_torch as ct
    from cylon_tpu_torch.ops import join as J
    from cylon_tpu_torch.ops import kernels as K

    ctx = ct.CylonContext.Init(device=device)
    n = 1 << args.rows_log2
    left, right, expect = profile_stream.join_tables(ct, ctx, n)
    keybits_sort, payload, (a_desc, b_desc) = profile_stream.stream_args(
        left, right)
    jt = J.JoinType.INNER

    def best(fn):
        return drill_common.best_of(fn, device)

    res = {"n_rows": n, "backend": device.type,
           "device": drill_common.card_name(device)}
    res["plan_s"] = best(lambda: K.join_plan_stream(**keybits_sort()))
    counts, a_s, b_s = K.join_plan_stream(**keybits_sort())
    res["n_primary"] = int(counts[0, 0])
    if res["n_primary"] != expect:
        raise AssertionError(f"K3 counts {res['n_primary']} output rows, "
                             f"numpy {expect}")
    cap = J.stream_expand_capacity(res["n_primary"],
                                   J.stream_block_rows(n, n))
    res["cap"] = cap
    plan = J.JoinPlan("stream", jt, counts, a_s, b_s, a_desc, b_desc)
    res["materialize_s"] = best(lambda: plan.materialize(*payload, cap))
    res["expand_s"] = best(lambda: K.join_expand_stream(counts, a_s, b_s,
                                                        cap))
    del counts, a_s, b_s, plan

    # micro-benchmarks on the stream sort's permutation of the 2n rows
    bits = torch.cat([left._columns[0].data, right._columns[0].data]
                     ).view(1, -1)
    m = 2 * n
    tag = torch.arange(m, dtype=torch.int64, device=device).view(1, -1)
    res["sort_fused_s"] = best(lambda: J._sort_by_bits_tag(bits, tag))
    perm = J._sort_by_bits_tag(bits, tag)[0]
    lanes = [bits[0], tag[0].to(torch.int32),
             torch.cat([left._columns[1].data, right._columns[1].data]
                       ).view(torch.int32),
             torch.cat([right._columns[1].data, left._columns[1].data]
                       ).view(torch.int32)]
    res["gather_1col_s"] = best(lambda: lanes[0][perm])
    res["gather_4x1col_s"] = best(lambda: [x[perm] for x in lanes])
    packed4 = torch.stack(lanes, 1)
    packed2 = packed4[:, :2].contiguous()
    res["gather_packed4_s"] = best(lambda: packed4[perm])
    res["gather_packed2_s"] = best(lambda: packed2[perm])
    if not torch.equal(packed4[perm], torch.stack([x[perm] for x in lanes],
                                                  1)):
        raise AssertionError("the packed gather disagrees with the "
                             "per-column gathers")
    del packed4
    rng = np.random.default_rng(1)
    dest = torch.from_numpy(rng.permutation(n)).to(device)
    src1 = lanes[0][:n]
    src2 = packed2[:n]
    res["scatter_1col_s"] = best(lambda: torch.zeros(
        n, dtype=torch.int32, device=device).index_copy_(0, dest, src1))
    res["scatter_packed2_s"] = best(lambda: torch.zeros(
        n, 2, dtype=torch.int32, device=device).index_copy_(0, dest, src2))
    res["cumsum_s"] = best(lambda: torch.cumsum(lanes[1], 0))
    return drill_common.finish(res, args.out, launches0)


if __name__ == "__main__":
    main()
