"""The generator: a seed gives the same tables, another seed others,
every column in its configured range and type."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import gen, harness, testing

CONFIGS = Path(__file__).resolve().parent / "configs"


def tiny(name, rows=5000):
    return testing.shrink(json.loads((CONFIGS / f"{name}.json").read_text()),
                          rows)


def values(x):
    return x.values if isinstance(x, gen.Strings) else x


def test_same_seed_same_tables():
    for name in ("cylon_join_200m", "h2o_groupby_1e8"):
        cfg = tiny(name)
        a = gen.make_tables(cfg, 2 ** 31 + 11, "cpu")
        b = gen.make_tables(cfg, 2 ** 31 + 11, "cpu")
        c = gen.make_tables(cfg, 2 ** 31 + 12, "cpu")
        for t in a:
            for (n1, x), (n2, y), (_n, z) in zip(a[t], b[t], c[t]):
                assert n1 == n2 and torch.equal(values(x), values(y))
                assert not torch.equal(values(x), values(z))


def test_columns_in_range_and_type():
    cfg = tiny("h2o_groupby_1e8", 20000)
    t = dict(gen.make_tables(cfg, 7, "cpu")["x"])
    spec = cfg["tables"]["x"]["columns"]
    for name, x in t.items():
        s = spec[name]
        if s["dtype"] == "string":
            assert isinstance(x, gen.Strings) and x.width == 2 + s["digits"]
        else:
            assert x.dtype == gen.DTYPES[s["dtype"]]
        x = values(x)
        assert float(x.min()) >= s["low"] and float(x.max()) < s["high"]
    v3 = t["v3"]
    assert torch.equal(torch.round(v3 * 1e6) / 1e6, v3)


@pytest.mark.parametrize("column", ["id1", "id3"])
def test_strings_as_the_port_ingests_them(column):
    """The string columns built on the device hold the db-benchmark
    values (``sprintf("id%03d")``, ``sprintf("id%010d")``) in the form
    the port's own ingest gives the same values: a dictionary for id1,
    varbytes for id3."""
    import cylon_tpu_torch as ct

    cfg = tiny("h2o_groupby_1e8", 3000)
    x = dict(gen.make_tables(cfg, 2 ** 31 + 17, "cpu")["x"])[column]
    fmt = "id%03d" if column == "id1" else "id%010d"
    want = np.array([fmt % v for v in x.values.tolist()], dtype=object)
    got = harness.string_column(ct, x, column)
    own = ct.Column.from_numpy(want, column)
    assert (got.dictionary is None) == (own.dictionary is None) \
        == (column == "id3")
    assert got.dtype == own.dtype
    assert list(got.to_numpy()) == list(want) == list(own.to_numpy())
    if column == "id3":
        vb, ob = got.varbytes, own.varbytes
        assert vb.max_words == ob.max_words == 3
        assert torch.equal(vb.words[:vb.total_words],
                           ob.words[:ob.total_words])
        assert len(vb.words) == len(ob.words)
    else:
        assert torch.equal(got.data.to(torch.int64),
                           x.values.to(torch.int64) - 1)
        assert list(got.dictionary) == sorted(got.dictionary)


def test_rank_slices_tile_the_table():
    cfg = tiny("h2o_groupby_1e8", 1001)
    full = gen.make_tables(cfg, 5, "cpu")
    parts = [gen.rank_slice(full, r, 3) for r in range(3)]
    for t, cols in full.items():
        for i, (_c, x) in enumerate(cols):
            assert torch.equal(torch.cat([values(p[t][i][1])
                                          for p in parts]), values(x))


def test_seed_above_32_bits():
    cfg = tiny("cylon_join_200m", 100)
    a = gen.make_tables(cfg, 2 ** 40 + 3, "cpu")
    assert len(a["left"][0][1]) == 100
