"""Warm Q1-double at tpch.sf1 on the card over three catalogs: the
generator (`tpch`), one parquet file per table (`pq`) and a hive layout of
ORC files partitioned by l_shipmode (`hive`).  For each, two rounds of five
warm walls, and a cProfile of one more warm run (host time by function,
by own time and by cumulative time).

    PYTHONHASHSEED=0 python3 tools/hive_warm_profile.py

Its last line is "DIAG OK"; the files are written to a temporary
directory and removed."""
import cProfile, io, os, pstats, shutil, sys, tempfile, time
here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, here)
import chip_smoke as cs
from trino_tpu_torch.kernels import build
from trino_tpu_torch.connectors import hive as phive
from trino_tpu_torch.connectors.api import CatalogManager
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.connectors.parquet import ParquetConnector, write_table_to_parquet
from trino_tpu_torch.runtime.runner import LocalQueryRunner

build.build_all(["grouped_sums", "locate_sorted"])
root = tempfile.mkdtemp(prefix="hive_warm_profile_")
try:
    tp = TpchConnector()
    phive.write_partitioned(tp, "sf1", "lineitem", root + "/h", ["l_shipmode"], fmt="orc")
    write_table_to_parquet(tp, "sf1", "lineitem", root + "/p")
    cm = CatalogManager()
    cm.register("hive", phive.HiveConnector(root + "/h"))
    cm.register("pq", ParquetConnector(root + "/p"))
    cm.register("tpch", tp)
    for cat in ("tpch", "pq", "hive", "tpch", "pq", "hive"):
        r = LocalQueryRunner(cm, catalog=cat, schema="sf1")
        r.execute("set session pallas_agg = true")
        r.execute(cs.Q1_DOUBLE)
        r.execute(cs.Q1_DOUBLE)
        ws = []
        for _ in range(5):
            t0 = time.perf_counter(); r.execute(cs.Q1_DOUBLE); ws.append(time.perf_counter() - t0)
        print(cat, "warm walls", sorted(ws), flush=True)
        pr = cProfile.Profile(); pr.enable(); r.execute(cs.Q1_DOUBLE); pr.disable()
        for key in ("tottime", "cumtime"):
            s = io.StringIO(); pstats.Stats(pr, stream=s).sort_stats(key).print_stats(22)
            print(cat, key, s.getvalue()[-5000:], flush=True)
finally:
    shutil.rmtree(root, ignore_errors=True)
print("DIAG OK")
