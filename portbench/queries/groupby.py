"""``Table.groupby`` of one key column."""


def run(tables, q):
    return tables[q["table"]].groupby(q["by"], list(q["columns"]),
                                      list(q["aggs"]))
