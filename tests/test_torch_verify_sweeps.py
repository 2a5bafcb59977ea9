"""The port's three benchmark sweeps against the JAX package's: the
capacity certificates (`verify/capacity.py`), the numeric-safety analyzer
(`verify/numeric.py`) and the collective-uniformity pass
(`verify/collectives.py`), with the schedule license beside them.

Each query is planned once per package (the 8-worker mesh runner's
`create_plan`, the plan the capacity and numeric sweeps read), and the
three checks run over that plan: the capacity counts (joins, licensed
joins, varchar-keyed licensed joins, licensed aggregations, violations),
the numeric counts (expressions, proven, baselined, violations, the
baseline keys used), then the distributed plan's fragment count, its
collective signature and its schedule license at W = 8 (and at W = 4 for
a seeded sample of about 20 TPC-DS queries; every TPC-H plan's is held at
both widths in test_torch_verify.py).  Equal per plan in every count means
equal totals.  Tier-1 sweeps every TPC-H query, a seeded half of TPC-DS
and the sweep's two varchar probes; `test_full_sweeps_equal_jax` (marked
`slow`) runs both packages' `verify_benchmarks` whole and compares their
totals, and the entry points' exit codes.
"""

import random

import pytest

from trino_tpu_torch.connectors.tpcds.queries import QUERIES as DS
from trino_tpu_torch.connectors.tpch.queries import QUERIES as H

from test_torch_tpcds import one_torch_thread  # noqa: F401 (autouse)

SEED = 16
DS_HALF = sorted(random.Random(SEED).sample(sorted(DS), len(DS) // 2))
DS_LICENSE_W4 = frozenset(random.Random(SEED + 1).sample(DS_HALF, 20))
CASES = (
    [("tpch", q) for q in sorted(H)]
    + [("tpcds", q) for q in DS_HALF]
    + [("tpcds", "varchar:c_customer_id"), ("tpcds", "varchar:d_date_id")]
)


class _Side:
    """One package's runners, sweep functions and numeric baseline."""

    def __init__(self, pkg: str):
        import importlib

        self.pkg = pkg
        self.capacity = importlib.import_module(f"{pkg}.verify.capacity")
        self.numeric = importlib.import_module(f"{pkg}.verify.numeric")
        self.collectives = importlib.import_module(f"{pkg}.verify.collectives")
        self.schedule = importlib.import_module(f"{pkg}.verify.schedule")
        self.plan = importlib.import_module(f"{pkg}.planner.plan")
        self.baseline = self.numeric.numeric_safety_baseline(".")
        self._runners: dict = {}

    def runner(self, catalog: str, w: int):
        key = (catalog, w)
        if key not in self._runners:
            if self.pkg == "trino_tpu":
                from trino_tpu.parallel import DistributedQueryRunner

                r = DistributedQueryRunner(catalog=catalog, schema="tiny", n_workers=w)
            else:
                from trino_tpu_torch.parallel import DistributedQueryRunner

                r = DistributedQueryRunner(catalog=catalog, schema="tiny", n_workers=w,
                                           device="cpu")
            r.properties.set("verify_plan", "strict")
            self._runners[key] = r
        return self._runners[key]

    def capacity_counts(self, plan, catalogs) -> dict:
        """The capacity sweep's per-plan counts (the JAX package keeps them
        inside `verify_benchmarks`; the port has `sweep_capacity_plan`)."""
        P, C = self.plan, self.capacity
        from trino_tpu_torch import types as T

        joins = [n for n in C._walk(plan) if isinstance(n, P.JoinNode)]
        licensed = [n for n in joins if getattr(n, "capacity_cert", None) is not None]
        violations = C.check_capacity_certificates(plan, catalogs)
        return {
            "joins": len(joins),
            "licensed": len(licensed),
            "varchar_licensed": sum(
                1 for n in licensed
                if any(T.is_string_kind(T.parse_type(l.type.name))
                       or T.is_string_kind(T.parse_type(r.type.name))
                       for l, r in n.criteria)
            ),
            "agg_licensed": sum(
                1 for n in C._walk(plan)
                if isinstance(n, P.AggregationNode)
                and getattr(n, "capacity_cert", None) is not None
            ),
            "violations": [v.rule for v in violations],
            "keys": sorted(str(n.capacity_cert.key) for n in licensed),
        }

    def check(self, catalog: str, q) -> dict:
        sql = _VARCHAR_SQL[q] if isinstance(q, str) else (H if catalog == "tpch" else DS)[q]
        r = self.runner(catalog, 8)
        plan = r.create_plan(sql)
        out = {"capacity": self.capacity_counts(plan, r.catalogs)}
        res = self.numeric.SweepResult()
        self.numeric.sweep_plan(plan, r.catalogs, self.baseline, res, f"{catalog}:{q}")
        out["numeric"] = (
            res.expressions, res.proven, res.baselined, sorted(res.used_baseline),
            sorted((w, i.key()) for w, i in res.violations),
        )
        sub = r.create_subplan(plan)
        assert self.collectives.check_collective_uniformity(sub) == []
        out["fragments"] = sum(1 for _ in sub.all_fragments())
        lic = self.schedule.license_schedule(sub, 8)
        out["license8"] = None if lic is None else lic.to_json()
        if catalog == "tpcds" and q in DS_LICENSE_W4:
            # the same plan fragmented for 4 workers (its certificates are
            # resealed for W = 4 after the W = 8 license was read)
            r4 = self.runner(catalog, 4)
            lic4 = self.schedule.license_schedule(r4.create_subplan(plan), 4)
            out["license4"] = None if lic4 is None else lic4.to_json()
        return out


_VARCHAR_SQL = {
    "varchar:c_customer_id": (
        "SELECT count(*) FROM customer c1 JOIN customer c2 "
        "ON c1.c_customer_id = c2.c_customer_id"
    ),
    "varchar:d_date_id": (
        "SELECT count(*) FROM date_dim d1 JOIN date_dim d2 ON d1.d_date_id = d2.d_date_id"
    ),
}


def test_varchar_probes_are_the_sweeps():
    from trino_tpu_torch.verify.capacity import VARCHAR_PROBES

    assert {q: sql for _, _, q, sql in VARCHAR_PROBES} == _VARCHAR_SQL


@pytest.fixture(scope="module")
def sides():
    return _Side("trino_tpu_torch"), _Side("trino_tpu")


@pytest.mark.parametrize("catalog,q", CASES, ids=[f"{c}-{q}" for c, q in CASES])
def test_sweeps_equal_jax(sides, catalog, q):
    port, jax = sides
    got, want = port.check(catalog, q), jax.check(catalog, q)
    assert got["capacity"] == want["capacity"]
    assert got["capacity"]["violations"] == []
    assert got["numeric"] == want["numeric"]
    assert got["numeric"][4] == []  # no numeric violation
    assert got["fragments"] == want["fragments"]
    assert got["license8"] == want["license8"]
    assert got.get("license4") == want.get("license4")


def test_port_sweep_functions_count_alike(sides, monkeypatch, capsys):
    """The port's sweep entry points over a two-query suite: the capacity
    totals equal the per-plan counts above, the numeric sweep reports no
    violation and no stale key it used, the collectives sweep counts the
    fragments; each `main` exits 0."""
    from trino_tpu_torch.verify import capacity, collectives, numeric

    suite = (("tpch", "tiny", {3: H[3], 18: H[18]}),)
    monkeypatch.setattr(collectives, "benchmark_suites", lambda: suite)
    monkeypatch.setattr(capacity, "VARCHAR_PROBES", ())
    port, _ = sides
    t = capacity.verify_benchmarks()
    per = [port.check("tpch", 3)["capacity"], port.check("tpch", 18)["capacity"]]
    assert t["queries"] == 2 and t["violations"] == 0
    for k in ("joins", "licensed", "agg_licensed", "varchar_licensed"):
        assert t[k] == sum(p[k] for p in per)
    res = numeric.verify_benchmarks()
    assert res.violations == [] and res.expressions > 0
    assert collectives.verify_benchmarks(n_workers=8) == sum(
        port.check("tpch", q)["fragments"] for q in (3, 18)
    )
    monkeypatch.setattr("sys.argv", ["prog"])
    assert collectives.main() == 0
    assert numeric.main() == 0
    # no varchar probe in this suite: the capacity CLI fails as the JAX one does
    assert capacity.main() == 1
    out = capsys.readouterr().out
    assert "capacity: 2 plans" in out and "numeric-safety:" in out
    assert "collective-uniformity:" in out


@pytest.mark.slow
def test_full_sweeps_equal_jax():
    """Both packages' whole sweeps (every TPC-H and TPC-DS plan, ~1 min a
    sweep a package on one core): equal totals, no violation."""
    from trino_tpu.verify import capacity as jcap, collectives as jcol, numeric as jnum
    from trino_tpu_torch.verify import capacity, collectives, numeric

    assert capacity.verify_benchmarks() == jcap.verify_benchmarks()
    got, want = numeric.verify_benchmarks(), jnum.verify_benchmarks()
    assert (got.expressions, got.proven, got.baselined, got.used_baseline) == (
        want.expressions, want.proven, want.baselined, want.used_baseline)
    assert [(w, i.key()) for w, i in got.violations] == [
        (w, i.key()) for w, i in want.violations]
    assert numeric.stale_keys(got) == {
        k for k in jnum.numeric_safety_baseline(".") if not k.startswith("trino_tpu/")
    } - want.used_baseline
    assert collectives.verify_benchmarks() == jcol.verify_benchmarks()
