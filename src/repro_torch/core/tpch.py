"""Synthetic TPC-H-like data generator (lineitem / orders / part).

Port copy of `repro.core.tpch`, kept in step with it so both packages read
and write the same bytes; the port never imports the JAX package.

Mirrors the distributions the paper's benchmark queries exercise (dates
uniform over 1992-1998, discount 0..0.10, small categorical domains) at a
configurable mini scale factor: sf=1.0 -> 600k lineitem rows (1/10 of real
TPC-H SF1, sized for the single-core container; fractions are what matter).

Dates are stored as int32 days since 1992-01-01 (DATE_EPOCH).  `sorted_by`
reproduces the paper's Fig. 3b sorted-vs-unsorted Parquet comparison
(lineitem on l_shipdate, orders on o_orderdate).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.lakeformat.schema import ColumnSchema, TableSchema
from repro_torch.lakeformat.writer import write_table

DAYS = 2556  # 1992-01-01 .. 1998-12-31
LI_PER_SF = 600_000
ORDERS_PER_SF = 150_000
PARTS_PER_SF = 20_000
SUPPS_PER_SF = 1_000

SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
SHIPINSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
RETURNFLAGS = ["A", "N", "R"]
LINESTATUS = ["O", "F"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
BRANDS = [f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)]
CONTAINERS = [f"{s} {t}" for s in ["SM", "MED", "LG", "JUMBO"] for t in ["CASE", "BOX", "PACK", "PKG"]]
TYPES = [f"{a} {b} {c}" for a in ["STANDARD", "SMALL", "MEDIUM", "LARGE", "PROMO"]
         for b in ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
         for c in ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]]


def lineitem_schema() -> TableSchema:
    return TableSchema(
        "lineitem",
        [
            ColumnSchema("l_orderkey", "int32", "auto"),
            ColumnSchema("l_partkey", "int32", "bitpack"),
            ColumnSchema("l_suppkey", "int32", "bitpack"),
            ColumnSchema("l_quantity", "int32", "bitpack"),
            ColumnSchema("l_extendedprice", "float32", "plain"),
            ColumnSchema("l_discount", "float32", "dict"),
            ColumnSchema("l_tax", "float32", "dict"),
            ColumnSchema("l_returnflag", "str"),
            ColumnSchema("l_linestatus", "str"),
            ColumnSchema("l_shipdate", "int32", "auto"),
            ColumnSchema("l_commitdate", "int32", "bitpack"),
            ColumnSchema("l_receiptdate", "int32", "bitpack"),
            ColumnSchema("l_shipmode", "str"),
            ColumnSchema("l_shipinstruct", "str"),
        ],
    )


def orders_schema() -> TableSchema:
    return TableSchema(
        "orders",
        [
            ColumnSchema("o_orderkey", "int32", "auto"),
            ColumnSchema("o_orderdate", "int32", "auto"),
            ColumnSchema("o_orderpriority", "str"),
        ],
    )


def part_schema() -> TableSchema:
    return TableSchema(
        "part",
        [
            ColumnSchema("p_partkey", "int32", "auto"),
            ColumnSchema("p_brand", "str"),
            ColumnSchema("p_type", "str"),
            ColumnSchema("p_container", "str"),
            ColumnSchema("p_size", "int32", "bitpack"),
        ],
    )


def gen_tables(sf: float = 0.1, seed: int = 0, sorted_data: bool = False) -> Dict[str, Dict]:
    rng = np.random.default_rng(seed)
    n_li = int(LI_PER_SF * sf)
    n_ord = int(ORDERS_PER_SF * sf)
    n_part = max(256, int(PARTS_PER_SF * sf))
    n_supp = max(64, int(SUPPS_PER_SF * sf))

    li_order = np.sort(rng.integers(0, n_ord, size=n_li)).astype(np.int64)
    shipdate = rng.integers(0, DAYS, size=n_li).astype(np.int64)
    lineitem = {
        "l_orderkey": li_order,
        "l_partkey": rng.integers(0, n_part, size=n_li),
        "l_suppkey": rng.integers(0, n_supp, size=n_li),
        "l_quantity": rng.integers(1, 51, size=n_li),
        "l_extendedprice": (rng.random(n_li).astype(np.float32) * 10000 + 900).round(2),
        "l_discount": (rng.integers(0, 11, size=n_li) / 100).astype(np.float32),
        "l_tax": (rng.integers(0, 9, size=n_li) / 100).astype(np.float32),
        "l_returnflag": [RETURNFLAGS[i] for i in rng.integers(0, 3, size=n_li)],
        "l_linestatus": [LINESTATUS[i] for i in rng.integers(0, 2, size=n_li)],
        "l_shipdate": shipdate,
        "l_commitdate": np.clip(shipdate + rng.integers(-30, 60, size=n_li), 0, DAYS),
        "l_receiptdate": np.clip(shipdate + rng.integers(1, 30, size=n_li), 0, DAYS),
        "l_shipmode": [SHIPMODES[i] for i in rng.integers(0, len(SHIPMODES), size=n_li)],
        "l_shipinstruct": [SHIPINSTRUCT[i] for i in rng.integers(0, 4, size=n_li)],
    }
    if sorted_data:  # paper footnote 2: lineitem sorted on l_shipdate
        order = np.argsort(lineitem["l_shipdate"], kind="stable")
        lineitem = {
            k: ([v[i] for i in order] if isinstance(v, list) else v[order])
            for k, v in lineitem.items()
        }

    orderdate = rng.integers(0, DAYS, size=n_ord).astype(np.int64)
    if sorted_data:  # orders sorted on o_orderdate
        orderdate = np.sort(orderdate)
    orders = {
        "o_orderkey": np.arange(n_ord, dtype=np.int64),
        "o_orderdate": orderdate,
        "o_orderpriority": [PRIORITIES[i] for i in rng.integers(0, 5, size=n_ord)],
    }

    part = {
        "p_partkey": np.arange(n_part, dtype=np.int64),
        "p_brand": [BRANDS[i] for i in rng.integers(0, len(BRANDS), size=n_part)],
        "p_type": [TYPES[i] for i in rng.integers(0, len(TYPES), size=n_part)],
        "p_container": [CONTAINERS[i] for i in rng.integers(0, len(CONTAINERS), size=n_part)],
        "p_size": rng.integers(1, 51, size=n_part),
    }
    return {"lineitem": lineitem, "orders": orders, "part": part}


def write_tables(dirpath: str, sf: float = 0.1, seed: int = 0, sorted_data: bool = False,
                 row_group_size: int = 65536) -> Dict[str, str]:
    import os

    os.makedirs(dirpath, exist_ok=True)
    data = gen_tables(sf, seed, sorted_data)
    paths = {}
    for name, schema in [("lineitem", lineitem_schema()), ("orders", orders_schema()),
                         ("part", part_schema())]:
        p = os.path.join(dirpath, f"{name}.lake")
        write_table(p, schema, data[name], row_group_size)
        paths[name] = p
    return paths
