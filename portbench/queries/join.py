"""``Table.distributed_join``: at one shard the local join, across
processes the shuffle join."""


def run(tables, q):
    return tables[q["left"]].distributed_join(
        tables[q["right"]], q.get("how", "inner"), on=q["on"])
