"""``Table.distributed_union``: at one shard the local set op, across
processes the shuffle and a set op a shard."""


def run(tables, q):
    return tables[q["left"]].distributed_union(tables[q["right"]])
