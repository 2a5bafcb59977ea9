#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (trino_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero (it
catches nothing and never falls back to the CPU):

  1. the card's name and power limit (nvidia-smi) and the torch/CUDA versions;
  2. build every kernel of the path from trino_tpu_torch/csrc with nvcc
     (one process per source, started together), with the build seconds and
     ptxas's register/shared-memory report, and fail on any register spill;
  3. hold the grouped-sums kernel to its plain PyTorch version on the card,
     at the main path's shape and at the edges (ragged and sub-tile row
     counts, rows whose bytes are not a multiple of 16, unaligned inputs),
     and time kernel (back to back, and per launch with the L2 flushed),
     plain version, a PyTorch library yardstick and the memory bound;
  4. the single-device aggregation path: TPC-H Q1, Q6 and Q1-over-DOUBLE
     (with `pallas_agg` on, the grouped-sums kernel's path) at sf1 through
     LocalQueryRunner on the card, cold and warm, with wall time, lineitem
     rows/s, kernel launches and peak device memory, then one profiled warm
     run each (planning time, device busy share, the top ops by device
     time); every result is checked against the port's own CPU run
     (device="cpu") of the same query (see "the checks of phases 4-5c");
  5. the join and mesh path: TPC-H Q3 at sf1 on a DistributedQueryRunner of
     4 logical workers on the card with `pallas_probe` on and with default
     knobs (both run the sorted-probe kernel on the card, and each run must
     launch it), and through LocalQueryRunner on the card, each cold and
     warm, with the same readings as phase 4 and the sorted-probe kernel's
     launches; every result is checked against the port's CPU
     LocalQueryRunner at sf1;
 5b. the semi-join, cross-join and conditional-form path: TPC-H Q4, Q11,
     Q12, Q18, Q19 and Q21 at sf1 through LocalQueryRunner on the card, and
     Q4, Q18, Q21 and Q11 (its cross join in the coordinator's local
     engine) on the 4-worker mesh with default knobs, each cold and warm,
     with the readings of phase 5; every mesh run of a semi-join query must
     launch the sorted-probe kernel from a semi join; one profiled warm run
     each of the mesh Q18 and Q21; each launch's P, n_match and window S;
     every result is checked against the port's CPU LocalQueryRunner at sf1
     (the CPU reference's time printed);
  5c. the scalar-function and DISTINCT path: TPC-H Q2, Q7, Q8, Q9, Q10, Q13,
     Q14, Q15, Q16, Q17, Q20 and Q22 at sf1 through LocalQueryRunner on the
     card and on the 4-worker mesh with default knobs, each cold and twice
     warm, with wall time, rows/s, peak device memory and the sorted-probe
     kernel's launches (every mesh run of a query with a sorted-probe join
     must launch it); one profiled warm run each of the local Q13 and the
     mesh Q9 and Q16; then, untimed, each mesh query's largest launch
     (P, cap_b, n_match, S) and the host time of Q13's LIKE table with the
     size of its dictionary; every result is checked against the port's CPU
     LocalQueryRunner at sf1.
     The checks of phases 4-5c: a reference process makes these CPU runs
     (after its phase 5k and 5l parts), so the card process does not spend
     its own cores on them; each phase keeps its results, and their checks
     run right after phase 5l (a failing one fails the script as before);
  5d. TPC-DS without windows: the 84 TPC-DS queries that have no window
     function at tpcds.sf1 (q72 at sf0_1, see TPCDS_SCHEMA) through
     LocalQueryRunner on the card and on the 4-worker mesh with default
     knobs, each cold and warm, with wall time, peak device memory and the
     sorted-probe kernel's launches (every mesh search whose key planes
     the kernel takes must launch it; the cold mesh run records each
     launch's (P, cap_b, n_match, S) and keeps the largest launch's
     inputs); one profiled warm run each of q78 (local and mesh) and q75
     (mesh); every result is held to the port's CPU run of the same
     query, which a reference process computes on the upper half of the
     cores while the card phases run, with each query's host planning time
     (ORDER BY keys in order, rows as a multiset where the ORDER BY leaves
     ties, keys only for the tie group a LIMIT cuts through:
     trino_tpu_torch/testing.py).  Phases 5d and 5e run, one after the
     other, in a second process on the card, started after the build and
     running beside phases 3-5l of the main one (on the same cores); q72,
     whose sf0_1 mesh run takes most of the card's memory, runs first,
     local then mesh, while the main process is in its small phases, and
     that process then gives the cached memory back.  The main process
     takes the two phases' launches, seconds and largest sorted-probe
     inputs once phase 5l is done;
  5e. TPC-DS with windows: the 14 windowed TPC-DS queries the JAX package
     answers (q12, q20, q36, q44, q47, q49, q53, q57, q63, q67, q70, q86,
     q89, q98) at tpcds.sf1, run and checked as in phase 5d (the same
     reference process computes them after phase 5d's queries); the cold runs log
     every window step (its input rows, each mesh worker's rows, the
     long-decimal sum/avg path: licensed or limb); one profiled warm mesh
     run of the query with the largest window input; q51 must raise the
     JAX package's NotImplementedError, local and mesh;
  5f. memory budgets: at sf1, the join of orders and lineitem, the
     aggregation of lineitem by l_orderkey, TPC-H Q18, an ORDER BY over all
     of orders and TPC-DS q67 through LocalQueryRunner on the card, and the
     same join, the same aggregation and TPC-H Q3 on the 4-worker mesh,
     each unbudgeted (cold, warm) and under a budget of a quarter of its
     unbudgeted footprint with spill to disk (cold, warm); the local join
     also with spill off, with two waves pinned, and revoked mid-probe by a
     shrinking pool limit.  Each budgeted run must equal the unbudgeted
     rows, raise the wave counter of its operator, spill exactly when spill
     is on and a spilling wave path ran, and leave no spill file and no
     live revocable; every unbudgeted run must record no wave, no spill
     and no revocation; every wave of a mesh wave join must launch the
     sorted-probe kernel.  Logged: the footprint, budget, k, spill bytes,
     warm walls, peak working set above the starting allocation, the host
     seconds of partitioning and of copies off the card, each mesh wave's
     launch shapes, and one profiled warm budgeted run each of the local
     and the mesh join; last, every budgeted result against the port's CPU
     run under the same budget (a mesh query's on the local runner);
  5g. arrays, maps and UNNEST at TPC-H sf1 (ARRAY_QUERIES, nothing reduced):
     U1 the sum and count of an UNNEST of two doubles per lineitem row by
     (l_returnflag, l_linestatus), 12,002,430 elements (locally with
     `pallas_agg` on: it must launch the grouped-sums kernel); U2 the mesh
     join of orders and lineitem with an UNNEST WITH ORDINALITY of two
     decimals, exact sums (the mesh run must launch the sorted-probe
     kernel; each launch's P, n_match and S logged); U3 array_agg(...
     ORDER BY ...) per l_orderkey (1,500,000 groups, K = 8) reduced to
     four sums; U4 array_agg per l_orderkey unnested again, which must
     also equal sum(l_quantity) and count(*) over lineitem; U5 the 20 most
     frequent words of split(c_comment, ' ') (the host seconds of split's
     dictionary table and its size logged); U6 transform, filter, reduce
     and a map lookup over every lineitem row, summed; U7 listagg and
     map_agg per r_name.  Each through LocalQueryRunner and the 4-worker
     mesh on the card, cold and warm, with wall time, peak device memory,
     the host reads that data-dependent widths took and the kernels'
     launches; one profiled warm run each of the local U1 and the mesh U3;
     then, untimed, one capture run of each query and runner that reads
     the K of every array value built, the bytes the mesh gathers moved,
     and the kernels' inputs (the local U1's largest grouped-sums launch,
     the mesh U2's sorted-probe launches); the local U3 under a budget
     above its footprint and under a quarter of it (raw-input waves,
     spilled), each equal to its unbudgeted rows; every result held to the
     port's CPU run of the same query, computed by the reference process
     (in order where the ORDER BY fixes it, as a multiset otherwise; U1
     with the kernel to Q1-double's f32 tolerance);
  5h. the streaming aggregates and the range-positional group path at TPC-H
     sf1 (AGGREGATE_QUERIES, nothing reduced): A1 global over lineitem
     (approx_distinct of l_orderkey, l_partkey and l_comment; checksum of
     a bigint, a decimal, a date, a varchar, a double and an integer with
     NULL rows; bool_and, bool_or, every, count_if); A2 corr, covar_samp,
     covar_pop, regr_slope, regr_intercept, checksum and bool_or by
     (l_returnflag, l_linestatus); A3 the join of orders and lineitem
     under corr, regr_slope, checksum and bool_and by o_orderpriority (the
     mesh run must launch the sorted-probe kernel; each launch's P,
     n_match and S logged from an untimed capture run); A4 the top ten
     groups of lineitem by l_suppkey (10,000 groups) and by l_orderkey
     (1,500,000 groups), whose local runs must take the range-positional
     group path and no sorted reduction.  Each through LocalQueryRunner
     and the 4-worker mesh on the card, cold and warm, with wall time,
     peak device memory, the kernels' launches and the group path each
     grouped reduction took; one profiled warm run each of the local A1
     and A4 by l_orderkey; every result held to the port's CPU run of the
     same query, computed by a reference process (REFERENCE_PARTS), the
     mesh A1 equal to the local A1, and A1's estimates within
     4% of the exact distinct counts;
  5i. the holistic aggregates, TABLESAMPLE and MATCH_RECOGNIZE at TPC-H sf1
     (HOLISTIC_QUERIES, nothing reduced): H1 global over lineitem (three
     approx_percentile qdigest sketches, min_by, max_by and max_by's n
     form); H2 the median and min_by/max_by per customer (~100,000
     groups; locally only the sorted group path, on the mesh the
     single-stage repartition and no partial states); H3 the mesh join of
     orders and lineitem under approx_percentile, max_by, min_by and
     count (the mesh run must launch the sorted-probe kernel; each
     launch's P, n_match and S logged from an untimed capture run, the
     largest kept for phase 6); S1 a 10% Bernoulli sample of lineitem
     (local only: its mesh run must raise NotImplementedError naming
     SampleNode, as the JAX mesh does; its total within 1% of 600,122);
     M1 Trino's V-shape example over orders (partitions by customer, the
     DEFINE masks on the card, the pattern walk on the host, whose seconds
     are logged apart from the device part).  Each through LocalQueryRunner
     and the 4-worker mesh on the card, cold and warm, with wall time, peak
     device memory, the kernels' launches and the group path of each
     grouped reduction; one profiled warm run each of the local H2 and the
     mesh H3; every result held to the port's CPU run of the same query
     (computed by a reference process, REFERENCE_PARTS), the
     values min_by/max_by pick among tied keys to the tied rows (witness
     queries the reference process runs), the mesh H1 equal to the local
     H1, H1's estimates within 1/32 relative of the exact percentiles;
  5j. the temporal types and the rest of the scalar-function layer at TPC-H
     sf1 (TEMPORAL_QUERIES, nothing reduced): T1 an hourly report in Q1's
     shape over timestamps (the local run with `pallas_agg` on must launch
     the grouped-sums kernel on every run); T2 delivery lateness in hours
     over the orders x lineitem join (the mesh run must launch the
     sorted-probe kernel); T3 time zones over orders (AT TIME ZONE,
     with_timezone, from_unixtime with zones, tz values rendered with their
     offsets and one ordering the rows); T4 a word histogram through a
     split_part table over the o_comment dictionary; T5 a breadth pass over
     customer (pads, translate, levenshtein_distance, bitwise, url_encode,
     codepoint, atan2, truncate, log, width_bucket); T6 concat_ws and format
     rendered per row on the host over customer's 150,000 rows.  Each
     through LocalQueryRunner and the 4-worker mesh on the card, cold and
     warm, with wall time, peak device memory, the kernels' launches, the
     group paths, the host tables built over a dictionary (entries and
     seconds) and the per-row renders' seconds; one profiled warm run each
     of the local T1 and the mesh T2; every result held to the port's CPU
     run of the same query (computed by a reference process,
     REFERENCE_PARTS), the local T1's f32 kernel sums to relative 5e-5;
  5k. the statement layer over the memory and blackhole catalogs at TPC-H
     sf1 (`statement_steps`, nothing reduced), one LocalQueryRunner
     (`pallas_agg` on) and one 4-worker mesh (`pallas_probe` on) over one
     CatalogManager: D1 a CTAS of lineitem's 6,001,215 rows into a memory
     table with DOUBLE columns, Q1 over it cold and warm (the grouped-sums
     kernel on every run), SHOW COLUMNS and SHOW STATS; D2 a CTAS of the
     1,500,000 orders, an INSERT ... SELECT of the 1998 orders, a DELETE, an
     UPDATE and a rolled-back DELETE, each followed by count and sum; D3 on
     the mesh a CTAS of the orders, a MERGE against lineitem's heavy orders
     and a Q3-shaped join with lineitem cold and warm (the sorted-probe
     kernel on every run); D4 a view of D1's Q1 and a prepared statement
     (PREPARE, EXECUTE, DESCRIBE OUTPUT, DEALLOCATE), local and mesh; D5 a
     60-day WITH RECURSIVE date series joined with the memory table, local
     and mesh; D6 EXPLAIN and EXPLAIN (TYPE DISTRIBUTED) of D1's Q1 local
     and mesh, EXPLAIN ANALYZE locally (each operator's wall and device time
     logged) and on the mesh (its profile's fragment ids and kinds held to
     the CPU mesh's fragments of the query), a blackhole CTAS (run right
     after D2's CTAS) and a read of it, ALTER TABLE (add a column, rename) and DROP TABLE with SHOW TABLES.
     Each step logs its wall (reads cold and warm), the peak device memory,
     the kernels' launches and the host seconds of each table write's three
     parts (rows to the host, the column build, the sink's append); one
     untimed capture run each after D1's Q1 and D3's join keeps the
     kernels' largest inputs (their launches counted apart).  Every result
     and the digest of every memory table after every step are held to the
     port's CPU run of the same steps (a reference process,
     REFERENCE_PARTS): local doubles (K1's f32 sums) to relative 5e-5, EXPLAIN
     text exactly, EXPLAIN ANALYZE's operator names, rows and batches, the
     tables' rows, codes and dictionaries exactly;
  5l. the query lifecycle at TPC-H sf1 (`run_lifecycle_path`): L1 Q1-double
     with `pallas_agg` and `query_trace` on through LocalQueryRunner, cold
     and warm (the grouped-sums kernel on every run), its one root span and
     the query/analyze/optimize/execute spans in system.runtime.spans, its
     FINISHED row of 4 in system.runtime.queries, its completed event's
     statistics (wall, rows, peak reservation, span count), and EXPLAIN
     ANALYZE VERBOSE (operator lines, the span tree, a `Trace JSON:` line
     that parses); L2 EXPLAIN ANALYZE of Q3 on the 4-worker mesh with
     `pallas_probe` on (the blocking profile: every fragment's phases sum
     to its wall, the fragment ids and kinds equal the CPU mesh's, the
     registry's mesh-event deltas equal the profile's counters,
     `last_mesh_profile.to_json()` logged) and the plain mesh Q3 cold and
     warm (the sorted-probe kernel on every run); L3 a planning deadline on
     Q1-double (which stays for a later Q6, and stops both before the card:
     the grouped-sums count does not move), a run deadline of a fifth of
     the warm wall of a CTAS of every order into memory (how far past the
     deadline the abort came is logged), and a second thread cancelling the
     same CTAS through `query_tracker.cancel` once it runs; after each
     abort the pool holds nothing, the spill directory is empty,
     system.runtime.queries shows the reason, and the next run gives the
     CPU run's rows; L4 a QueryDispatcher over one LocalQueryRunner with 2
     lanes and the groups etl (weight 1, one at a time) and adhoc (weight
     3, two at a time): six threads submit twelve statements (Q1-double,
     Q6, Q3 and Q18, local), every result held to the CPU run, the
     resource-groups table counting 12 admitted and a flooded third group
     (max_queued 1) shedding, with the gate-wait histogram, each
     statement's gate wait and the wall of the twelve against three times
     the sum of the serial warm walls logged; L5 a runner built by
     runner_from_etc from an etc/ directory written under build/ (tpch and
     memory catalogs, the file event listener): two queries and their
     created and completed events in the file, system.runtime.nodes
     listing the card, device bytes in caches, a SET SESSION value in
     session_properties, and system.metrics.metrics' queries total, which
     must have grown by exactly the statements the runner ran.  The
     lifecycle outcomes (state, error type, error code) are held to the
     CPU run's, and every result to the port's CPU run (a reference
     process, REFERENCE_PARTS); times are logged, never compared;
  5m. the collective-schedule license, bucketed layouts and the lock
     graph at tpch.sf1 on the 4-worker mesh: M1 Q3, Q5 and Q18, cold and
     warm, each run's `collective_async` equal to its license's licensed
     children and its sorted-probe launches logged, `device_residency`
     over the warm Q3 (no step built, no host re-entry, the recorded and
     licensed collective schedule), then the warm Q3 30 times with the
     license and 30 times without it, in turns (the license dropped in
     this script only), both medians logged; M2 a runner with
     `table_layouts` (orders and lineitem bucketed on the order key, 8
     buckets) and `colocated_join`: the lineitem-orders join with no
     repartition and one sorted-probe launch per worker shard, equal to
     the same join unbucketed, Q3 and Q18 equal to M1's, then a bucketed
     CTAS of 1,500,000 orders into memory (its wall logged) joined with
     the bucketed lineitem under the same checks; M3 the aggregation by
     l_orderkey over the bucketed lineitem in one stage (no repartition,
     no partial states), equal to the unbucketed run, with its group path
     and grouped-sums launches logged; M4 phase 5l's L4 (twelve
     statements on 2 lanes) under `verify.lockgraph.capture()`, every
     result held to 5l's CPU run, the graph's edges logged and required
     acyclic.  M1's rows are held to the port's CPU run with phases
     4-5c's;
  5n. fault-tolerant execution and the query performance observatory at
     tpch.sf1.  N1: the 4-worker mesh Q3 and Q18 under retry_policy =
     'TASK', each run clean, with `stage:<fid>:finish` failing once on a
     join's build-side fragment, and with `stage:<fid>:spooled` failing
     once on the probe-side fragment (the fragments found from the plan);
     every stage visited once but the failed one (twice), one duplicate
     attempt discarded in the :spooled runs, the retry counter up by one,
     every run launching the sorted-probe kernel after reading a spooled
     stage output, and no spool directory left; nation grouped by region
     with its scan stage failing four times raises StageFailedException;
     each run's spool bytes written and read and the host seconds of
     `_spool` and `_load_spooled` logged, and the warm Q3 five times with
     TASK and five times without, in turns, both medians logged.  N2: a
     runner from an etc/ directory under build/ with `profile.archive-dir`
     and `audit.log-path` (the 4-worker mesh given the same store and log)
     runs Q1-double (local, `pallas_agg`, the grouped-sums kernel) and the
     mesh Q3, cold (the step cache emptied and the kernel libraries
     forgotten) then warm: one artifact on disk per statement whose phases
     sum to its wall, one audit line per statement with increasing
     sequence numbers, `system.runtime.compilations` with a `kernel:` row
     for each library loaded again and no event in the warm runs,
     `system.runtime.plan_decisions` with the mesh Q3's join distributions
     (bytes and a verdict), `system.runtime.query_profiles` listing every
     statement, and the statement thread's artifact-assembly seconds
     logged.  N1's and N2's rows are held to the port's CPU run with phases
     4-5c's;
  5o. serving on the card at tpch.sf1: the port's coordinators on 127.0.0.1
     with ephemeral ports.  O1: a CoordinatorServer with a password
     authenticator (alice, admin) over a runner built by runner_from_etc
     from an etc/ directory under build/ (tpch and memory catalogs, 2
     dispatcher lanes, `pallas_agg` on, an access-control file: alice may
     SELECT tpch only, admin anything); alice runs Q1, Q6 and Q1-double
     over HTTP with Basic credentials through the Client, cold and warm
     (Q1-double must launch the grouped-sums kernel); a wrong password and
     no credentials get 401; alice's CTAS into memory fails with
     AccessDeniedError and creates no table; admin's CREATE ROLE, GRANT,
     SHOW GRANTS, REVOKE, SHOW ROLES and DROP ROLE answer as they must.
     O2: a CoordinatorServer over the 4-worker mesh: Q3 and Q18 over HTTP,
     cold and warm, each launching the sorted-probe kernel.  O3: eight
     DB-API connections run Q6 one after the other, then all at once on
     O1's 2 lanes, both walls logged.  O4: about 100,000 lineitem rows in
     key order (SERVE_PAGED) paged 4,096 rows a page, equal to the
     in-process card run's rows; the served wall against the in-process
     wall, split into the engine's wall, the queue, the encoding seconds,
     the client's decoding, the long-poll waits and the requests that
     carried data.  O5: a ProxyServer in front of O1's server and the
     verifier (testing/verifier.py) with the in-process card runner as
     control and DB-API through the proxy as test: Q1, Q3, Q6 and Q18 must
     be MATCH.  O1's, O2's and O3's rows are held to the port's CPU run
     with phases 4-5c's;
  5p. the multi-host worker tier on the card at tpch.sf1, every process
     under the cluster secret (TRINO_TPU_CLUSTER_SECRET).  P1: a
     MultiHostQueryRunner on the card over three WorkerServers on the
     card, two on threads of this process (their K1 launches are counted)
     and one started as `python -m trino_tpu_torch.server.worker --device
     cuda --port 0` under PYTHONHASHSEED=0; tests/test_multihost.py's
     seven queries, Q1-double under `pallas_agg` (K1 in the single-stage
     aggregation each in-process worker runs over the lineitem rows
     repartitioned to it; its cold run keeps the largest launch's inputs)
     and Q3 and Q18, cold and warm, each with its wall, the tasks
     per worker and, per stage, the bytes serialized and pulled over HTTP
     and the host seconds of the copy off the card, bucketing, encoding and
     decoding (from the merged cross-host trace); every materialized batch
     list a plan reads (pulled page sets, merged shards, coordinator-side
     fragments) must lie on the card.  P2: through a CoordinatorServer over
     that runner, an unsigned PUT /v1/worker/register gets 401 "bad
     signature"; a signed drain of the process worker makes the next Q1
     plan at W = 2 (the process then exits); add_worker of a fresh
     in-process worker, W = 3; a signed register of a second worker
     process, which is terminated at the query's first result pull: Q3
     re-plans once at W = 3; a HeartbeatDetector tick follows, and
     system.runtime.nodes must show the killed worker DEAD with its breaker
     open.  P4: a signed register of another in-process worker, then
     Q1-double and Q3 served over /v1/statement through the Client at
     W = 4.  P3: a DistributedQueryRunner on the card resized 4 -> 2 -> 4
     (`resize_mesh`), Q3 at each width with its K2 launches and the scan
     entries the resize dropped; the W = 2 run keeps its largest K2
     launch's inputs.  Every result is held to the port's CPU run (Q1, Q3,
     Q18 and Q1-double with phases 4-5c's; the seven queries computed last
     by the reference process);
  5q. restart prewarm on the card at tpch.sf1.  Q1: in this (warm)
     process, a CoordinatorServer over a LocalQueryRunner (`pallas_agg`
     on) with `prewarm.manifest-path` set serves Q1-double and Q6, and its
     shutdown saves their workload manifest; a PrewarmExecutor over the
     4-worker mesh records and saves Q3's; both in a temporary directory.
     Q2: a fresh card process (`chip_smoke.py --prewarm-card OUT LOCAL
     MESH sf1`, a real restart) builds one coordinator over a local runner
     (its executor attached from `prewarm.manifest-path`) and one over the
     4-worker mesh (its executor attached before the server); each
     replays its manifest on start through the dispatcher's
     `system_admission` and must reach WARM with `verify_events` 0, the
     local replay launching K1 and the mesh replay K2; then the first real
     run of each statement through its coordinator must record zero
     compile events above the watermark.  Q3: a second fresh card process
     without manifests (`--prewarm-card OUT - - sf1`) gives the cold first
     walls.  Q4: in the prewarmed process the mesh is resized 4 -> 2 -> 4;
     each kicked replay must reach WARM and the next Q3 record zero
     compile events at the new signature.  The replays' walls and each
     first query's wall with and without prewarm are logged (findings,
     not a claim); every result is held to the port's CPU run with phases
     4-5c's;
  6a. hold the grouped-sums kernel to its plain version, as in phase 3, at
     the inputs of the local U1's largest launch (N = 2**21 unnested rows),
     of the local T1's, of D1's Q1's (phase 5k), of L1's Q1-double
     (phase 5l) and of a 5p worker's Q1-double aggregation, and
     time it there;
  6. hold the sorted-probe kernel to its plain version on the card, bit for
     bit, at the inputs of the largest launch of phase 5 and at the edges
     (duplicate runs and misses, runs crossing window edges and runs longer
     than several windows, all rows nomatch, n_match in {0, 1, S - 1,
     S + 1} and not a multiple of S, a plane whose length is not a multiple
     of S, ragged and small probe lengths, keys at INT64_MIN/MAX, an int32
     plane, build planes large enough for S = 16 and S = 512), and time
     kernel (back to back, and per launch with the L2 flushed), plain
     version, the torch.searchsorted yardstick and the bound; also bit-exact
     at the inputs of the largest and of the smallest-n_match semi-join
     launch of phase 5b, and timed at the largest; bit-exact and timed at
     the inputs of the largest launch of phases 5c, 5d and 5g; bit-exact
     at the largest launch of phase 5e; bit-exact and timed at the largest
     launch of the mesh H3 (phase 5i), of the mesh T2 (phase 5j), of D3's
     mesh join (phase 5k), of L2's mesh Q3 (phase 5l), of M2's
     co-located join (phase 5m), of N1's largest launch fed by a spooled
     stage output (phase 5n) and of the W = 2 mesh Q3 after `resize_mesh`
     (phase 5p);
  7. one JSON line with the kernels;
  8. last line: {"ok": true, "device": {...}}.

The CPU references are made by two processes on the upper half of the
cores: one for phases 5d and 5e, one for every other phase
(REFERENCE_PARTS).  The TPC-H text pools (comments) are drawn from a
generator seeded with Python's string hash, so the script runs itself, and
so every process it starts, under PYTHONHASHSEED=0: all then see the same
c_comment words.

Tolerances: integers, decimals, dates, timestamps, tz values (instant and
offset) and strings exact.  Kernel sums: counts
exact, |kernel - plain| <= 5e-5 * (sum of |values| in the cell), the f32
summation bound of the kernel (~530 sequential additions * 2**-24).  Q1 over
DOUBLE with the f32 kernel against the CPU's f64 path: relative 5e-5 on
doubles (all summed values are non-negative), counts exact; every other
double relative 1e-9.  A min_by/max_by value where keys tie: the value
of any of the tied rows (which one depends on the rows' arrival order).
The sorted-probe kernel: bit-exact.
"""

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS = 67e12  # H100 SXM float32 peak outside the tensor cores
LINEITEM_SF1_ROWS = 6_001_215
KERNEL_RTOL = 5e-5
MESH_WORKERS = 4
DOUBLE_RTOL = 1e-9
#: phase 5b: the local queries, and the mesh queries (the first three hold
#: semi joins, Q11 a cross join)
SEMI_LOCAL_QIDS = (4, 11, 12, 18, 19, 21)
SEMI_MESH_QIDS = (4, 18, 21, 11)
SEMI_JOIN_QIDS = (4, 18, 21)
#: phase 5c: the scalar-function and DISTINCT slice's queries, and Q10 and
#: Q15 (ported earlier, first run on the card here), locally and on the mesh
FUNC_QIDS = (2, 7, 8, 9, 10, 13, 14, 15, 16, 17, 20, 22)
#: the phase 5c mesh queries that hold a join the sorted-probe kernel takes
#: (Q22's only join is the cross join with its scalar subquery)
FUNC_PROBE_QIDS = (2, 7, 8, 9, 10, 13, 14, 15, 16, 17, 20)
#: phase 5e: the TPC-DS queries with a window function; phase 5d runs the
#: other 84
TPCDS_WINDOW_QIDS = frozenset({12, 20, 36, 44, 47, 49, 51, 53, 57, 63, 67, 70, 86, 89, 98})
#: q51 raises in the JAX package (a running max over a decimal(38,2) sum),
#: and must raise the same error in the port, local and mesh
TPCDS_RAISING = {
    51: "window min/max over a long-decimal input column "
        "(cast to decimal(18,s) or double first)",
}
#: the phase 5d queries that run below sf1: q72's plan (the JAX package's
#: join order, which the port keeps) joins catalog_sales to inventory
#: before any filter, ~940 M rows at sf1.  Under a 256 MiB budget with 64
#: waves it runs locally on the card at sf1 and matches the CPU run
#: (tools/q72_budget_probe.py), but that CPU run takes ~11 minutes of
#: eight cores, more than this script's reference processes can spare, and
#: the mesh would hold the whole expansion on the card
TPCDS_SCHEMA = {72: "sf0_1"}
#: phase 5d's profiled warm runs: a star join over the three sales
#: channels and their returns (local and mesh) and a union of the three
#: channels (mesh)
TPCDS_PROFILES = ((78, "local"), (78, "mesh"), (75, "mesh"))

#: phase 5g: arrays, maps and UNNEST at TPC-H sf1
ARRAY_QUERIES = {
    "U1": (
        "select l_returnflag, l_linestatus, sum(e), count(e) from lineitem "
        "cross join unnest(array[cast(l_extendedprice as double), "
        "cast(l_extendedprice as double) * (1 - cast(l_discount as double))]) u(e) "
        "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus"
    ),
    "U2": (
        "select o_orderpriority, n, sum(e), count(*) from orders "
        "join lineitem on o_orderkey = l_orderkey "
        "cross join unnest(array[l_quantity, l_discount]) with ordinality u(e, n) "
        "group by o_orderpriority, n order by o_orderpriority, n"
    ),
    "U3": (
        "select count(*), sum(cardinality(a)), sum(a[1]), sum(element_at(a, -1)) from "
        "(select l_orderkey, array_agg(l_linenumber order by l_linenumber) a "
        "from lineitem group by l_orderkey)"
    ),
    "U4": (
        "select sum(q), count(*) from (select l_orderkey, array_agg(l_quantity) a "
        "from lineitem group by l_orderkey) cross join unnest(a) u(q)"
    ),
    "U5": (
        "select w, count(*) c from customer cross join unnest(split(c_comment, ' ')) u(w) "
        "group by w order by c desc, w limit 20"
    ),
    "U6": (
        "select sum(reduce(transform(array[cast(l_quantity as double), "
        "cast(l_discount as double), cast(l_tax as double)], x -> x * 2), "
        "0e0, (s, x) -> s + x, s -> s)), "
        "sum(cardinality(filter(array[l_linenumber, l_suppkey, l_partkey], x -> x > 100))), "
        "sum(element_at(map(array[1, 2, 3, 4, 5, 6, 7], "
        "array[10, 20, 30, 40, 50, 60, 70]), l_linenumber)), count(*) from lineitem"
    ),
    "U7": (
        "select r_name, listagg(n_name, ',') within group (order by n_name), "
        "cardinality(map_agg(n_name, n_nationkey)) from nation "
        "join region on n_regionkey = r_regionkey group by r_name order by r_name"
    ),
}
#: U4's round trip must equal these totals over lineitem
ARRAY_U4_TOTALS = "select sum(l_quantity), count(*) from lineitem"
#: the one phase 5g query whose local run takes the grouped-sums kernel
#: (`pallas_agg` on), and the one whose mesh join takes the sorted probe
ARRAY_K1_QUERY, ARRAY_K2_QUERY = "U1", "U2"

#: phase 5h: the streaming aggregates and the range-positional group path at
#: TPC-H sf1 (nothing reduced).  A1 global over lineitem (sketches,
#: checksums of six argument types, one with NULL rows, the booleans); A2
#: the bivariate family by Q1's keys; A3 the mesh join (K2) under the
#: bivariate family; A4 integer group keys (10,000 and 1,500,000 groups).
AGGREGATE_QUERIES = {
    "A1": (
        "select approx_distinct(l_orderkey), approx_distinct(l_partkey), "
        "approx_distinct(l_comment), checksum(l_orderkey), checksum(l_extendedprice), "
        "checksum(l_shipdate), checksum(l_comment), "
        "checksum(cast(l_extendedprice as double)), checksum(nullif(l_linenumber, 1)), "
        "bool_and(l_quantity >= 1), bool_or(l_shipdate > date '1998-11-30'), "
        "every(l_tax <= 0.08), count_if(l_returnflag = 'R') from lineitem"
    ),
    "A2": (
        "select l_returnflag, l_linestatus, corr(l_extendedprice, l_quantity), "
        "covar_samp(l_extendedprice, l_quantity), covar_pop(l_discount, l_tax), "
        "regr_slope(l_extendedprice, l_quantity), regr_intercept(l_extendedprice, l_quantity), "
        "checksum(l_partkey), bool_or(l_discount > 0.09), count(*) from lineitem "
        "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus"
    ),
    "A3": (
        "select o_orderpriority, corr(o_totalprice, l_extendedprice), "
        "regr_slope(l_extendedprice, l_quantity), checksum(l_partkey), "
        "bool_and(l_receiptdate > o_orderdate), count(*) "
        "from orders join lineitem on o_orderkey = l_orderkey "
        "group by o_orderpriority order by o_orderpriority"
    ),
    "A4_suppkey": (
        "select l_suppkey, count(*) c, sum(l_quantity), max(l_shipdate) from lineitem "
        "group by l_suppkey order by c desc, l_suppkey limit 10"
    ),
    "A4_orderkey": (
        "select l_orderkey, sum(l_extendedprice) s, count(*) from lineitem "
        "group by l_orderkey order by s desc, l_orderkey limit 10"
    ),
}
#: the exact distinct counts A1's estimates are held to (within 4%)
AGGREGATE_EXACT = "select count(distinct l_orderkey), count(distinct l_partkey) from lineitem"
#: the phase 5h query whose mesh run must launch the sorted-probe kernel
AGGREGATE_K2_QUERY = "A3"

#: phase 5i: the holistic aggregates, TABLESAMPLE and MATCH_RECOGNIZE at TPC-H
#: sf1 (nothing reduced).  H1 global streaming sketches and min_by/max_by
#: over all of lineitem; H2 per customer (~100,000 groups); H3 the mesh join
#: (K2) under holistic aggregates; S1 a 10% Bernoulli sample (local only:
#: the mesh raises, as the JAX mesh does); M1 Trino's V-shape example from
#: the row-pattern-recognition documentation, over orders.
HOLISTIC_QUERIES = {
    "H1": (
        "select approx_percentile(l_extendedprice, 0.5), approx_percentile(l_discount, 0.9), "
        "approx_percentile(cast(l_quantity as double), 0.99), "
        "min_by(l_orderkey, l_extendedprice), max_by(l_comment, l_shipdate), "
        "max_by(l_orderkey, l_extendedprice, 3) from lineitem"
    ),
    "H2": (
        "select o_custkey, approx_percentile(o_totalprice, 0.5) m, "
        "min_by(o_orderdate, o_totalprice), max_by(o_orderkey, o_orderdate, 2) "
        "from orders group by o_custkey order by m desc, o_custkey limit 20"
    ),
    "H3": (
        "select o_orderpriority, approx_percentile(l_extendedprice, 0.25), "
        "max_by(l_orderkey, l_extendedprice), min_by(l_shipmode, l_receiptdate), count(*) "
        "from orders join lineitem on o_orderkey = l_orderkey "
        "group by o_orderpriority order by o_orderpriority"
    ),
    "S1": (
        "select l_returnflag, l_linestatus, count(*), sum(l_quantity) "
        "from lineitem tablesample bernoulli (10) group by 1, 2 order by 1, 2"
    ),
    "M1": (
        "select * from orders match_recognize (partition by o_custkey "
        "order by o_orderdate, o_orderkey measures first(o_totalprice) as strt, "
        "min(down.o_totalprice) as bottom, last(up.o_totalprice) as top, "
        "match_number() as mno one row per match after match skip past last row "
        "pattern (strt down+ up+) define down as o_totalprice < prev(o_totalprice), "
        "up as o_totalprice > prev(o_totalprice))"
    ),
}
#: the phase 5i queries the mesh does not run (it must raise, naming the node)
HOLISTIC_LOCAL_ONLY = {"S1": "SampleNode"}
#: the phase 5i query whose mesh run must launch the sorted-probe kernel
HOLISTIC_K2_QUERY = "H3"
#: the exact nearest-rank percentiles H1's estimates are held to (within
#: 1/32 relative): the grouped percentile, which is exact, over one group
HOLISTIC_EXACT = (
    "select g, approx_percentile(l_extendedprice, 0.5), approx_percentile(l_discount, 0.9), "
    "approx_percentile(cast(l_quantity as double), 0.99) "
    "from (select 1 g, l_extendedprice, l_discount, l_quantity from lineitem) group by g"
)
#: min_by/max_by pick the first row that holds a group's extreme key, and
#: the rows' arrival order (parallel split readers, the mesh's exchanges)
#: decides which one that is when keys tie: any of the tied rows' values is
#: right (SQL leaves the choice open).  Per query: the result columns that
#: hold the group keys, then per column (result column, min | max, n of the
#: n form or None, the SQL of witness rows (group keys..., key, value) that
#: hold every row at or beyond each group's n-th extreme key; "{groups}" is
#: the result's group keys).  A column passes when its value is one the
#: witness rows admit.
HOLISTIC_TIES = {
    "H1": ((), (
        (3, "min", None, "select l_extendedprice, l_orderkey from lineitem "
         "where l_extendedprice = (select min(l_extendedprice) from lineitem)"),
        (4, "max", None, "select l_shipdate, l_comment from lineitem "
         "where l_shipdate = (select max(l_shipdate) from lineitem)"),
        (5, "max", 3, "select l_extendedprice, l_orderkey from lineitem "
         "where l_extendedprice >= (select min(p) from (select l_extendedprice p "
         "from lineitem order by p desc limit 3) t)"),
    )),
    "H2": ((0,), (
        (2, "min", None, "select o_custkey, o_totalprice, o_orderdate from orders "
         "where o_custkey in ({groups})"),
        (3, "max", 2, "select o_custkey, o_orderdate, o_orderkey from orders "
         "where o_custkey in ({groups})"),
    )),
    "H3": ((0,), (
        (2, "max", None, "select o_orderpriority, l_extendedprice, l_orderkey "
         "from orders join lineitem on o_orderkey = l_orderkey "
         "where l_extendedprice >= (select min(m) from (select o_orderpriority, "
         "max(l_extendedprice) m from orders join lineitem on o_orderkey = l_orderkey "
         "group by o_orderpriority) t)"),
        (3, "min", None, "select o_orderpriority, l_receiptdate, l_shipmode "
         "from orders join lineitem on o_orderkey = l_orderkey "
         "where l_receiptdate <= (select max(m) from (select o_orderpriority, "
         "min(l_receiptdate) m from orders join lineitem on o_orderkey = l_orderkey "
         "group by o_orderpriority) t)"),
    )),
}
#: S1 keeps ~10% of lineitem's 6,001,215 rows: its count within 1% of this
HOLISTIC_SAMPLE_ROWS = 600_122

#: phase 5j: the temporal types and the rest of the scalar-function layer at
#: TPC-H sf1 (nothing reduced).  T1 an hourly report in Q1's shape (the local
#: run with `pallas_agg` on: K1); T2 delivery lateness in hours over the
#: orders x lineitem join (the mesh run: K2); T3 time zones over orders, tz
#: values rendered with their offsets and one ordering the rows; T4 a word
#: histogram over the o_comment dictionary (a split_part table); T5 a
#: data-quality breadth pass over customer (pad, translate, levenshtein,
#: bitwise, url, math tables and functions); T6 the per-row host renders
#: (concat_ws, format) over customer's 150,000 rows.  Named zones resolve on
#: the host clock when a query is planned, so only Asia/Kolkata (no DST) and
#: fixed offsets appear: the card run and the reference agree whenever they
#: run.
TEMPORAL_QUERIES = {
    "T1": (
        "select l_returnflag, l_linestatus, sum(cast(l_extendedprice as double)), "
        "avg(cast(l_discount as double)), count(*) from lineitem "
        "where date_add('hour', l_linenumber, cast(l_shipdate as timestamp)) "
        "<= timestamp '1998-09-02 00:00:00' "
        "and hour(date_add('minute', l_orderkey % 1440, cast(l_shipdate as timestamp))) "
        "between 8 and 17 group by 1, 2 order by 1, 2"
    ),
    "T2": (
        "select o_orderpriority, count(*), "
        "sum(date_diff('hour', cast(o_orderdate as timestamp), cast(l_receiptdate as timestamp))), "
        "max(date_trunc('day', cast(l_commitdate as timestamp))) "
        "from orders join lineitem on o_orderkey = l_orderkey "
        "where to_unixtime(cast(l_receiptdate as timestamp)) "
        "> to_unixtime(cast(l_commitdate as timestamp)) group by 1 order by 1"
    ),
    "T3": (
        "select o_orderkey, cast(o_orderdate as timestamp) at time zone 'Asia/Kolkata' a, "
        "with_timezone(cast(o_orderdate as timestamp), '+05:30') w, "
        "timezone_hour(from_unixtime(o_orderkey * 997, 'Asia/Kolkata')), "
        "cast(from_unixtime(o_orderkey * 997, '-03:30') as timestamp), "
        "minute(from_unixtime(o_orderkey * 997)), second(from_unixtime(o_orderkey * 997)), "
        "millisecond(from_unixtime(cast(o_orderkey as double) / 1000)) "
        "from orders order by w desc, o_orderkey limit 20"
    ),
    "T4": (
        "select split_part(o_comment, ' ', 2) w, count(*), sum(o_totalprice) "
        "from orders group by 1 order by 2 desc, 1 limit 10"
    ),
    "T5": (
        "select width_bucket(c_acctbal, -1000, 10000, 11) b, count(*), "
        "max(lpad(c_name, 22, '*')), "
        "min(rpad(translate(c_mktsegment, 'AEIOU', 'aeiou'), 12, '.')), "
        "max(levenshtein_distance(c_phone, '25-989-741-2988')), "
        "sum(bit_count(c_custkey, 64)), sum(bitwise_xor(c_custkey, c_nationkey)), "
        "max(url_encode(c_address)), max(codepoint(substr(c_name, 1, 1))), "
        "sum(truncate(atan2(c_acctbal, 100.0) * 1000)), count_if(is_nan(log(2, c_acctbal))) "
        "from customer group by 1 order by 1"
    ),
    "T6": (
        "select concat_ws('|', c_name, c_mktsegment, c_phone), "
        "format('%s owes %.2f', c_name, c_acctbal), typeof(c_acctbal) "
        "from customer order by c_custkey limit 5"
    ),
}
#: the phase 5j query whose local run takes the grouped-sums kernel
#: (`pallas_agg` on), and the one whose mesh join takes the sorted probe
TEMPORAL_K1_QUERY, TEMPORAL_K2_QUERY = "T1", "T2"
#: the phase 5j queries whose host tables over a dictionary are timed, and
#: the one whose per-row host renders are
TEMPORAL_TABLE_QUERIES = ("T4", "T5")
TEMPORAL_RENDER_QUERY = "T6"

#: phase 5k: the statement layer over the memory and blackhole catalogs at
#: TPC-H sf1 (nothing reduced: D1's CTAS copies all 6,001,215 lineitem rows).
#: A step is one or more statements run in order by one runner: "local" (a
#: LocalQueryRunner with `pallas_agg` on, so K1 sums its doubles) or "mesh"
#: (the 4-worker DistributedQueryRunner with `pallas_probe` on); both share
#: one CatalogManager.  A `repeat` step is a read, run cold and warm; a
#: `raises` step must raise NotImplementedError naming that text (the
#: reference process skips it); an `analyze` step is an EXPLAIN ANALYZE,
#: compared on its operator names, rows= and batches=; a `fragments` step
#: is the mesh's EXPLAIN ANALYZE, compared on its profile's fragment ids
#: and kinds.  The blackhole CTAS
#: runs right after D2's CTAS, while memory.default.ord still holds all
#: 1,500,000 orders.
STATEMENT_RECURSIVE = (
    "with recursive d(x) as (select date '1998-06-01' union all "
    "select x + interval '1' day from d where x < date '1998-07-30') "
    "select count(*), sum(l_extendedprice) from d join memory.default.li on l_shipdate = d.x"
)
STATEMENT_MERGE = (
    "merge into memory.default.ord_m t using (select l_orderkey k, sum(l_quantity) q "
    "from tpch.{s}.lineitem group by l_orderkey having sum(l_quantity) > 300) s "
    "on t.o_orderkey = s.k when matched and s.q > 312 then delete "
    "when matched then update set o_totalprice = o_totalprice + 1"
)
STATEMENT_JOIN = (
    "select o_orderkey, sum(l_extendedprice * (1 - l_discount)) revenue, o_orderdate "
    "from memory.default.ord_m join tpch.{s}.lineitem on l_orderkey = o_orderkey "
    "where o_orderdate < date '1995-03-15' and l_shipdate > date '1995-03-15' "
    "group by o_orderkey, o_orderdate order by revenue desc, o_orderdate, o_orderkey limit 10"
)
STATEMENT_PREPARE = (
    "prepare p from select l_returnflag, count(*), sum(l_extendedprice) "
    "from memory.default.li where l_quantity < ? group by 1 order by 1"
)
ORDERS_COLUMNS = "o_orderkey, o_custkey, o_orderstatus, o_totalprice, o_orderdate"


class StatementStep:
    def __init__(self, label: str, where: str, *statements, repeat: bool = False,
                 raises: str = "", analyze: bool = False, fragments: bool = False):
        self.label = label
        self.where = where
        self.statements = statements
        self.repeat = repeat
        self.raises = raises
        self.analyze = analyze
        #: the mesh's EXPLAIN ANALYZE: compared on its profile's fragment
        #: ids and kinds (the reference fragments the query on a CPU mesh)
        self.fragments = fragments

    @property
    def group(self) -> str:
        return self.label.split("_")[0]


def statement_steps(schema: str) -> list:
    """Phase 5k's steps over tpch.`schema` (sf1 on the card, tiny in the
    tests), in order."""
    S = StatementStep
    q1 = STATEMENT_Q1.format(table="memory.default.li")
    count_ord = "select count(*), sum(o_totalprice) from memory.default.ord"
    steps = [
        S("D1_ctas", "local",
          "create table memory.default.li as select l_returnflag, l_linestatus, "
          "cast(l_quantity as double) l_quantity, "
          "cast(l_extendedprice as double) l_extendedprice, "
          "cast(l_discount as double) l_discount, cast(l_tax as double) l_tax, l_shipdate "
          f"from tpch.{schema}.lineitem"),
        S("D1_q1", "local", q1, repeat=True),
        S("D1_columns", "local", "show columns from memory.default.li"),
        S("D1_stats", "local", "show stats for memory.default.li"),
        S("D2_ctas", "local",
          f"create table memory.default.ord as select {ORDERS_COLUMNS} "
          f"from tpch.{schema}.orders"),
        S("D6_blackhole_ctas", "local",
          "create table blackhole.default.sink as select * from memory.default.ord"),
        S("D6_blackhole_select", "local", "select * from blackhole.default.sink"),
        S("D2_insert", "local",
          f"insert into memory.default.ord select {ORDERS_COLUMNS} "
          f"from tpch.{schema}.orders where o_orderdate >= date '1998-01-01'"),
        S("D2_after_insert", "local", count_ord),
        S("D2_delete", "local", "delete from memory.default.ord where o_orderstatus = 'P'"),
        S("D2_after_delete", "local", count_ord),
        S("D2_update", "local",
          "update memory.default.ord set o_totalprice = o_totalprice + 1.00 "
          "where o_orderdate between date '1992-01-01' and date '1992-12-31'"),
        S("D2_after_update", "local", count_ord),
        S("D2_rollback", "local", "start transaction",
          "delete from memory.default.ord where o_custkey % 3 = 0", "rollback"),
        S("D2_after_rollback", "local", count_ord),
        S("D3_ctas", "mesh",
          f"create table memory.default.ord_m as select {ORDERS_COLUMNS} "
          f"from tpch.{schema}.orders"),
        S("D3_merge", "mesh", STATEMENT_MERGE.format(s=schema)),
        S("D3_after_merge", "mesh",
          "select count(*), sum(o_totalprice) from memory.default.ord_m"),
        S("D3_join", "mesh", STATEMENT_JOIN.format(s=schema), repeat=True),
    ]
    for where in ("local", "mesh"):
        steps += [
            S(f"D4_create_view_{where}", where,
              f"create view memory.default.q1v as {q1}"),
            S(f"D4_select_view_{where}", where, "select * from memory.default.q1v",
              repeat=True),
            S(f"D4_prepare_{where}", where, STATEMENT_PREPARE),
            S(f"D4_execute_{where}", where, "execute p using 24", repeat=True),
            S(f"D4_describe_{where}", where, "describe output p"),
            S(f"D4_deallocate_{where}", where, "deallocate prepare p"),
            S(f"D5_recursive_{where}", where, STATEMENT_RECURSIVE, repeat=True),
            S(f"D6_explain_{where}", where, f"explain {q1}"),
            S(f"D6_explain_distributed_{where}", where, f"explain (type distributed) {q1}"),
        ]
    steps += [
        S("D6_explain_analyze_local", "local", f"explain analyze {q1}", analyze=True),
        S("D6_explain_analyze_mesh", "mesh", f"explain analyze {q1}", fragments=True),
        S("D6_alter_add_column", "local",
          "alter table memory.default.ord add column o_note varchar"),
        S("D6_alter_rename", "local",
          "alter table memory.default.ord rename to memory.default.ord_renamed"),
        S("D6_show_tables_before_drop", "local", "show tables from memory.default"),
        S("D6_drop", "local", "drop table memory.default.li",
          "drop table memory.default.ord_renamed", "drop table memory.default.ord_m",
          "drop table blackhole.default.sink"),
        S("D6_show_tables", "local", "show tables from memory.default"),
    ]
    return steps


#: phase 5k: Q1 over the memory table's DOUBLE columns (`{table}`: the
#: table the statement reads, memory.default.li or a view's)
STATEMENT_Q1 = (
    "select l_returnflag, l_linestatus, sum(l_quantity), sum(l_extendedprice), "
    "sum(l_extendedprice * (1 - l_discount)), "
    "sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)), avg(l_quantity), "
    "avg(l_extendedprice), avg(l_discount), count(*) from {table} "
    "where l_shipdate <= date '1998-09-02' "
    "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus"
)

Q1_DOUBLE = """select l_returnflag, l_linestatus,
       sum(cast(l_quantity as double)), sum(cast(l_extendedprice as double)),
       sum(cast(l_extendedprice as double) * (1 - cast(l_discount as double))),
       avg(cast(l_quantity as double)), avg(cast(l_discount as double)), count(*)
from lineitem where l_shipdate <= date '1998-09-02'
group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus"""


def log(*args):
    print(*args, flush=True)


def cuda_ms_l2_flushed(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one fn() launch whose inputs start outside the
    L2: before each launch a 128 MB scratch tensor (2.5x the 50 MB L2) is
    written, then CUDA events bracket that launch alone.  The same
    device-side sleep as `cuda_ms` lets the host queue every launch first."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(reps)
    ]
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    for i, (start, end) in enumerate(events):
        flush.fill_(i & 0xFF)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / reps


def time_kernel(name: str, fn, bound_ms: float) -> dict:
    """Both times of one kernel call and their shares of the bound."""
    ms = cuda_ms(fn)
    flushed = cuda_ms_l2_flushed(fn)
    log(
        f"{name}: kernel_ms={ms!r} (bound share {bound_ms / ms:.3f}) "
        f"ms_l2_flushed={flushed!r} (bound share {bound_ms / flushed:.3f}) "
        f"bound_ms={bound_ms!r}"
    )
    return {"ms": ms, "ms_l2_flushed": flushed}


def check_ptxas(names) -> None:
    """ptxas's report of every kernel function: registers, shared memory,
    and no spill stores or loads."""
    from trino_tpu_torch.kernels import build

    for name in names:
        report = build.log_path(name).read_text()
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", report)
        if not spills:
            raise AssertionError(f"{name}: no ptxas report in the build log")
        if any(int(a) or int(b) for a, b in spills):
            raise AssertionError(f"{name}: ptxas reports register spills:\n{report}")
        log(f"ptxas {name}: {len(spills)} functions, no spills")


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `reps` launches, by CUDA events.  A
    device-side sleep first holds the stream while the launches queue up
    behind it, so host launch overhead does not open gaps between them
    (a function that synchronizes inside still pays its host time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # ~25 ms of device cycles
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- phase 3: the grouped-sums kernel against its plain version ---------------


def grouped_sums_inputs(n, g, k, live_fraction, seed, dev):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    gids = torch.randint(0, g, (n,), generator=gen, dtype=torch.int32)
    mask = torch.rand(n, generator=gen) < live_fraction
    values = torch.rand((n, k), generator=gen, dtype=torch.float32)
    values[:, 0] = 1.0  # a count column
    return gids.to(dev), mask.to(dev), values.to(dev)


def hold_grouped_sums(name, gids, mask, values, g) -> float:
    """Launch the grouped-sums kernel once and hold it to its plain version:
    every column of 0/1 values (a count) exact, every cell within
    KERNEL_RTOL x the cell's sum of |values|; the max |err|."""
    from trino_tpu_torch.ops import grouped_sums as gs

    out = gs.grouped_sums(gids, mask, values, g)
    torch.cuda.synchronize()
    ref = gs.grouped_sums_reference(gids, mask, values, g)
    scale = gs.grouped_sums_reference(gids, mask, values.abs(), g)
    err = (out - ref).abs()
    max_abs_err = float(err.max())
    counts = ((values == 0) | (values == 1)).all(dim=0)
    if not torch.equal(out[:, counts], ref[:, counts]):
        raise AssertionError(f"grouped_sums {name}: counts differ")
    if not bool((err <= KERNEL_RTOL * scale).all()):
        raise AssertionError(
            f"grouped_sums {name}: max |err| {max_abs_err} exceeds "
            f"{KERNEL_RTOL} x the cell's sum of |values|"
        )
    log(f"grouped_sums check {name}: N={gids.shape[0]} G={g} K={values.shape[1]} "
        f"count columns={int(counts.sum())} max_abs_err={max_abs_err!r} ok")
    return max_abs_err


def time_grouped_sums(name, gids, mask, values, g, dev) -> dict:
    """The kernel (back to back and L2-flushed), its plain version, the
    one-hot matmul yardstick and the bound at one launch's inputs."""
    from trino_tpu_torch.ops import grouped_sums as gs

    n, k = values.shape
    plain_ms = cuda_ms(lambda: gs.grouped_sums_reference(gids, mask, values, g))
    onehot = torch.logical_and(
        gids[:, None] == torch.arange(g, device=dev, dtype=gids.dtype)[None, :],
        mask[:, None],
    ).to(torch.float32)
    torch.backends.cuda.matmul.allow_tf32 = False
    library_ms = cuda_ms(lambda: torch.matmul(onehot.T, values))
    # the bytes this input needs: gid + mask of every row, the values of the
    # live rows only (the kernel skips dead rows), the [G, K] result
    live_rows = int(mask.sum())
    nbytes = n * (4 + 1) + live_rows * 4 * k + 4 * g * k
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = live_rows * k / F32_FLOPS * 1e3  # one f32 add per live value
    bound_ms = max(bytes_ms, ops_ms)
    times = time_kernel(
        f"grouped_sums {name}", lambda: gs.grouped_sums(gids, mask, values, g), bound_ms
    )
    log(
        f"grouped_sums {name}: plain_ms={plain_ms!r} "
        f"library_ms={library_ms!r} (one-hot f32 matmul, TF32 off) "
        f"bound_ms={bound_ms!r} ({nbytes} bytes, {live_rows} live rows)"
    )
    return {
        **times,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "n": n, "g": g, "k": k,
    }


def check_grouped_sums(dev) -> dict:
    shapes = [
        # (name, N, G, K, live fraction, row offset): the main path's
        # per-batch shape (Q1-double: 2**20-row scan batches, 12 group
        # slots, 11 columns), then the edges.  The staged tiles are 512
        # rows; a row offset of 1 makes every input start off a 16-byte
        # boundary (read in place).  Phase 5g's U1 shape is held at the
        # inputs its local run captured (check_grouped_sums_captured).
        ("main", 1 << 20, 12, 11, 0.78, 0),
        ("g1", 2048, 1, 1, 0.7, 0),
        ("g512", 2048, 512, 11, 0.7, 0),
        ("g512_k32", 8192, 512, 32, 0.7, 0),
        ("k200_tiled", 4096, 512, 200, 0.7, 0),
        ("all_masked", 1 << 20, 12, 11, 0.0, 0),
        ("ragged_n", (1 << 20) + 77, 12, 11, 0.78, 0),
        ("sub_tile_n", 300, 12, 11, 0.78, 0),
        ("one_tile_plus_1", 513, 12, 11, 0.78, 0),
        ("k3_rows_not_16b", 100_003, 12, 3, 0.78, 0),
        ("k5_rows_not_16b", 4099, 7, 5, 0.78, 0),
        ("unaligned", 100_000, 12, 11, 0.78, 1),
    ]
    from trino_tpu_torch.ops import grouped_sums as gs

    main = None
    for name, n, g, k, live, offset in shapes:
        gids, mask, values = grouped_sums_inputs(n + offset, g, k, live, seed=n + g + k, dev=dev)
        gids, mask, values = gids[offset:], mask[offset:], values[offset:]
        max_abs_err = hold_grouped_sums(name, gids, mask, values, g)
        if live == 0.0 and bool(gs.grouped_sums(gids, mask, values, g).any()):
            raise AssertionError("grouped_sums all_masked: nonzero output")
        if name == "main":
            main = (g, gids, mask, values, max_abs_err)

    g, gids, mask, values, max_abs_err = main
    timed = time_grouped_sums("main", gids, mask, values, g, dev)
    keys = ("ms", "ms_l2_flushed", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {
        "name": "grouped_sums",
        "route": "cuda",
        "source": "trino_tpu_torch/csrc/grouped_sums.cu",
        "replaces": "trino_tpu/ops/pallas_agg.py:62",
        "max_abs_err": max_abs_err,
        **{k: timed[k] for k in keys},
    }


def check_grouped_sums_captured(dev, capture: dict, path: str = "arrays") -> dict:
    """The grouped-sums kernel held to its plain version, and timed, at the
    inputs of the largest launch of one path's kernel query (phase 5g's
    local U1, phase 5j's local T1), captured in an untimed run after the
    path's counts were read."""
    if "largest" not in capture:
        raise AssertionError(f"no grouped-sums launch was captured on the {path} path")
    gids, mask, values, g = capture["largest"]
    max_abs_err = hold_grouped_sums(f"{path}_{capture['query']}", gids, mask, values, g)
    out = time_grouped_sums(f"{path}_{capture['query']}", gids, mask, values, g, dev)
    return {**out, "max_abs_err": max_abs_err, "query": capture["query"]}


# -- phase 4: the main path ----------------------------------------------------


def rows_match(actual, expected, float_rtol: float) -> None:
    if len(actual) != len(expected):
        raise AssertionError(f"row count {len(actual)} != {len(expected)}")
    for ra, re in zip(actual, expected):
        for va, ve in zip(ra, re):
            if isinstance(ve, float):
                if not math.isclose(va, ve, rel_tol=float_rtol, abs_tol=0.0):
                    raise AssertionError(f"{va!r} != {ve!r} (rel {float_rtol})")
            elif type(va) is not type(ve) or va != ve:
                raise AssertionError(f"{va!r} != {ve!r}\n{ra}\n{re}")


def profile_warm(name: str, runner, sql: str) -> None:
    """One more warm run under torch.profiler: host planning time, the
    card's busy time (the sum of kernel and copy times; the path runs on
    one stream) against the wall, and the device ops that take the most
    time."""
    from torch.profiler import ProfilerActivity, profile

    from trino_tpu_torch.sql.parser import parse_statement

    t0 = time.perf_counter()
    runner.plan_query(parse_statement(sql).query)
    plan_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.execute(sql)
        wall = time.perf_counter() - t0

    # kernels and copies are the CUDA-typed events; the aten ops that
    # launched them carry the same time again, so they are left out
    events = sorted(
        (e for e in prof.key_averages()
         if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA),
        key=lambda e: e.device_time_total,
        reverse=True,
    )
    busy_s = sum(e.device_time_total for e in events) / 1e6
    log(
        f"profile {name} warm: wall_s={wall!r} plan_s={plan_s!r} "
        f"device_events={len(events)} device_busy_s={busy_s!r} "
        f"device_idle_share={1 - busy_s / wall!r}"
    )
    copies = {
        way: sum(e.device_time_total for e in events if f"Memcpy {way}" in e.key) / 1e3
        for way in ("HtoD", "DtoH", "DtoD")
    }
    log(f"  {name} copies device_ms={copies}")
    for e in events[:8]:
        log(
            f"  {name} device op {e.key[:70]!r}: calls={e.count} "
            f"device_ms={e.device_time_total / 1e3!r}"
        )
    for e in events:  # the port's own kernels, wherever they rank
        if "grouped_sums" in e.key or "locate_sorted" in e.key:
            log(
                f"  {name} kernel {e.key[:70]!r}: calls={e.count} "
                f"device_ms={e.device_time_total / 1e3!r}"
            )


def run_main_path() -> dict:
    from trino_tpu_torch.connectors.tpch.queries import QUERIES
    from trino_tpu_torch.ops import grouped_sums as gs
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    queries = [
        ("q1", QUERIES[1], False),
        ("q6", QUERIES[6], False),
        ("q1_double", Q1_DOUBLE, True),
    ]
    runner = LocalQueryRunner(catalog="tpch", schema="sf1")
    kernel_runner = LocalQueryRunner(catalog="tpch", schema="sf1")
    kernel_runner.execute("set session pallas_agg = true")
    results = {}
    gs.grouped_sums.launches = 0  # every kernel count, just before the main path
    for name, sql, use_kernel in queries:
        r = kernel_runner if use_kernel else runner
        walls = []
        for attempt in ("cold", "warm", "warm"):
            before = gs.grouped_sums.launches
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = r.execute(sql)  # rows come back to the host: synchronized
            wall = time.perf_counter() - t0
            walls.append(wall)
            log(
                f"{name} {attempt}: wall_s={wall!r} "
                f"lineitem_rows_per_s={LINEITEM_SF1_ROWS / wall!r} "
                f"grouped_sums_launches={gs.grouped_sums.launches - before} "
                f"max_memory_allocated={torch.cuda.max_memory_allocated()}"
            )
        results[name] = (sql, res, min(walls[1:]))
    for name, sql, use_kernel in queries:
        profile_warm(name, kernel_runner if use_kernel else runner, sql)
    launches = gs.grouped_sums.launches  # read just after the main path
    log(f"main path: grouped_sums launches={launches}")
    if launches <= 0:
        raise AssertionError("the main path never launched grouped_sums")
    for name, (sql, res, warm) in results.items():
        log(f"{name} warm: wall_s={warm!r} lineitem_rows_per_s={LINEITEM_SF1_ROWS / warm!r}")

    def check(cpu: dict) -> None:
        # the port's own CPU run of every query (f64 paths) as the reference
        for name, (sql, res, _) in results.items():
            rows, cpu_s = cpu[sql]
            rtol = KERNEL_RTOL if name == "q1_double" else 0.0
            rows_match(res.rows, rows, float_rtol=rtol)
            log(f"{name}: {len(res.rows)} rows match the CPU run "
                f"(cpu wall_s={cpu_s!r}); first row {res.rows[0]}")

    return {"launches": launches, "check": check}


# -- phase 5: the join and mesh path ------------------------------------------


def recording_probe(capture: dict):
    """A stand-in for the mesh join's call of the sorted-probe wrapper: it
    passes every call through (the wrapper alone counts the launch), notes
    the launch shapes in capture["shapes"] and, while capture["keep"] is
    set, keeps copies of the inputs of the largest launch in
    capture["inputs"]."""
    import trino_tpu_torch.parallel.runner as mesh_runner

    kernel = mesh_runner.locate_sorted

    def recording(build, n_match, probe, nomatch, cap_b):
        out = kernel(build, n_match, probe, nomatch, cap_b=cap_b)
        capture.setdefault("shapes", set()).add(
            (probe.shape[0], build.shape[0], cap_b)
        )
        size = probe.shape[0] * max(build.shape[0], 1)
        if capture.get("keep") and size > capture.get("size", -1):
            capture.update(
                size=size,
                inputs=(build.clone(), n_match.clone(), probe.clone(),
                        nomatch.clone(), cap_b),
            )
        return out

    return kernel, recording


def capture_probe_inputs(mesh, sql: str, capture: dict) -> None:
    """One untimed run of `sql` on `mesh` that copies the inputs of its
    largest sorted-probe launch into capture["inputs"]."""
    import trino_tpu_torch.parallel.runner as mesh_runner

    kernel, recording = recording_probe(capture)
    capture["keep"] = True
    mesh_runner.locate_sorted = recording
    try:
        mesh.execute(sql)
    finally:
        mesh_runner.locate_sorted = kernel
        capture["keep"] = False


def run_mesh_path(capture: dict) -> dict:
    """TPC-H Q3 at sf1: the 4-worker mesh with `pallas_probe` on and with
    default knobs (on the card both take the sorted-probe kernel), and the
    local runner (the direct-address join).  `capture` receives the inputs
    of the largest sorted-probe launch."""
    from trino_tpu_torch.connectors.tpch.queries import QUERIES
    from trino_tpu_torch.ops import locate_sorted as ls
    from trino_tpu_torch.parallel.runner import DistributedQueryRunner
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    sql = QUERIES[3]
    kernel_mesh = DistributedQueryRunner(
        catalog="tpch", schema="sf1", n_workers=MESH_WORKERS
    )
    kernel_mesh.execute("set session pallas_probe = true")
    plain_mesh = DistributedQueryRunner(
        catalog="tpch", schema="sf1", n_workers=MESH_WORKERS
    )
    local = LocalQueryRunner(catalog="tpch", schema="sf1")
    runs = [
        ("q3_mesh_kernel", kernel_mesh),
        ("q3_mesh", plain_mesh),
        ("q3_local", local),
    ]

    import trino_tpu_torch.parallel.runner as mesh_runner

    kernel, recording = recording_probe(capture)
    results = {}
    mesh_runner.locate_sorted = recording
    ls.locate_sorted.launches = 0  # every kernel count, just before the path
    for name, r in runs:
        walls = []
        for attempt in ("cold", "warm", "warm"):
            before = ls.locate_sorted.launches
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = r.execute(sql)  # rows come back to the host: synchronized
            wall = time.perf_counter() - t0
            walls.append(wall)
            if name.startswith("q3_mesh") and ls.locate_sorted.launches == before:
                raise AssertionError(f"{name} {attempt}: no locate_sorted launch")
            ex = getattr(r, "last_stage_executor", None)
            log(
                f"{name} {attempt}: wall_s={wall!r} "
                f"lineitem_rows_per_s={LINEITEM_SF1_ROWS / wall!r} "
                f"locate_sorted_launches={ls.locate_sorted.launches - before} "
                f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
                f"memory_allocated_after={torch.cuda.memory_allocated()}"
                + ("" if ex is None else f" mesh_events={ex.counters}")
            )
        results[name] = (res, min(walls[1:]))
    for name, r in runs:
        profile_warm(name, r, sql)
    launches = ls.locate_sorted.launches  # read just after the path
    mesh_runner.locate_sorted = kernel
    # untimed, and after the count was read: copies phase 6's inputs
    capture_probe_inputs(kernel_mesh, sql, capture)
    log(f"mesh path: locate_sorted launches={launches} "
        f"shapes (P, build rows, cap_b)={sorted(capture.get('shapes', ()))}")
    if launches <= 0:
        raise AssertionError("the mesh path never launched locate_sorted")
    for name, (res, warm) in results.items():
        log(f"{name} warm: wall_s={warm!r} lineitem_rows_per_s={LINEITEM_SF1_ROWS / warm!r}")

    def check(cpu: dict) -> None:
        rows, cpu_s = cpu[sql]
        log(f"q3 cpu reference: wall_s={cpu_s!r}")
        for name, (res, _) in results.items():
            rows_match(res.rows, rows, float_rtol=0.0)
            log(f"{name}: {len(res.rows)} rows match the CPU run; first row {res.rows[0]}")

    return {"launches": launches, "check": check}


# -- phase 5b: semi joins, cross joins and the conditional forms ---------------


def _in_semi_join() -> bool:
    """Whether the running sorted-probe call comes from a mesh semi join:
    the frame that called the mesh's probe search (the `search` closure of
    `StageExecutor._probe_search`) is a `_x_SemiJoinNode` closure.  The
    walk up the stack finds the search by its qualified name (Python 3.11
    or later), not by a fixed depth.  Should the port's calls change shape
    so that no semi-join caller is found, phase 5b's check that every mesh
    run of a semi-join query launches the kernel from a semi join fails."""
    frame = sys._getframe(1)
    search = "_probe_search.<locals>"
    while frame is not None and search not in frame.f_code.co_qualname:
        frame = frame.f_back
    while frame is not None and search in frame.f_code.co_qualname:
        frame = frame.f_back
    return frame is not None and "_x_SemiJoinNode.<locals>" in frame.f_code.co_qualname


def semi_recording_probe(record: dict):
    """A stand-in for the mesh's call of the sorted-probe wrapper that
    passes every call through (the wrapper alone counts the launch) and
    counts the launches made from a semi join in record["semi"].  While
    record["keep"] is set it also notes each semi-join launch's P, n_match
    (a host read) and cap_b in record["launches"], and keeps copies of the
    inputs of the largest launch and of the smallest-n_match one."""
    import trino_tpu_torch.parallel.runner as mesh_runner

    kernel = mesh_runner.locate_sorted

    def recording(build, n_match, probe, nomatch, cap_b):
        out = kernel(build, n_match, probe, nomatch, cap_b=cap_b)
        if not _in_semi_join():
            return out
        record["semi"] = record.get("semi", 0) + 1
        if record.get("keep"):
            nm = int(n_match)
            inputs = (build.clone(), n_match.clone(), probe.clone(), nomatch.clone(), cap_b)
            record.setdefault("launches", []).append(
                (record.get("query"), probe.shape[0], build.shape[0], cap_b, nm)
            )
            size = probe.shape[0] * max(build.shape[0], 1)
            if size > record.get("largest_size", -1):
                record.update(largest_size=size, largest=inputs)
            if nm < record.get("min_n_match", math.inf):
                record.update(min_n_match=nm, smallest=inputs)
        return out

    return kernel, recording


def run_semi_cross_path(record: dict) -> dict:
    """Phase 5b: the six queries through the local runner on the card and
    four of them on the 4-worker mesh, cold and warm, each checked against
    the port's CPU run at sf1.  `record` receives the semi-join launches'
    shapes and the inputs phase 6 checks the kernel on."""
    import trino_tpu_torch.parallel.runner as mesh_runner
    from trino_tpu_torch.connectors.tpch.queries import QUERIES
    from trino_tpu_torch.ops import locate_sorted as ls
    from trino_tpu_torch.parallel.runner import DistributedQueryRunner
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    local = LocalQueryRunner(catalog="tpch", schema="sf1")
    mesh = DistributedQueryRunner(catalog="tpch", schema="sf1", n_workers=MESH_WORKERS)
    runs = [(f"q{q}_local", q, local) for q in SEMI_LOCAL_QIDS]
    runs += [(f"q{q}_mesh", q, mesh) for q in SEMI_MESH_QIDS]
    kernel, recording = semi_recording_probe(record)
    results = {}
    mesh_runner.locate_sorted = recording
    ls.locate_sorted.launches = 0  # every kernel count, just before the path
    try:
        for name, q, r in runs:
            walls = []
            for attempt in ("cold", "warm", "warm"):
                before = ls.locate_sorted.launches
                semi_before = record.get("semi", 0)
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                res = r.execute(QUERIES[q])  # rows come back to the host
                wall = time.perf_counter() - t0
                walls.append(wall)
                semi = record.get("semi", 0) - semi_before
                if r is mesh and q in SEMI_JOIN_QIDS and semi == 0:
                    raise AssertionError(f"{name} {attempt}: no semi-join locate_sorted launch")
                ex = getattr(r, "last_stage_executor", None)
                log(
                    f"{name} {attempt}: wall_s={wall!r} "
                    f"lineitem_rows_per_s={LINEITEM_SF1_ROWS / wall!r} "
                    f"locate_sorted_launches={ls.locate_sorted.launches - before} "
                    f"semi_join_launches={semi} "
                    f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
                    f"memory_allocated_after={torch.cuda.memory_allocated()} "
                    f"rows={len(res.rows)}"
                    + ("" if ex is None or r is not mesh else f" mesh_events={ex.counters}")
                )
            results[name] = (q, res, walls[0], min(walls[1:]))
        for q in (18, 21):
            profile_warm(f"q{q}_mesh", mesh, QUERIES[q])
    finally:
        mesh_runner.locate_sorted = kernel
    launches = ls.locate_sorted.launches  # read just after the path
    record["semi_path"] = record.get("semi", 0)
    log(f"semi/cross path: locate_sorted launches={launches} "
        f"from semi joins={record['semi_path']}")
    if launches <= 0:
        raise AssertionError("the semi/cross path never launched locate_sorted")
    # untimed, after the count was read: every semi-join launch's shape, and
    # the inputs phase 6 checks the kernel on
    mesh_runner.locate_sorted = recording
    record["keep"] = True
    try:
        for q in SEMI_JOIN_QIDS:
            record["query"] = f"q{q}"
            mesh.execute(QUERIES[q])
    finally:
        mesh_runner.locate_sorted = kernel
        record["keep"] = False
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for query, p, rows, cap_b, nm in record.get("launches", []):
        log(f"semi-join launch {query}: P={p} build_rows={rows} cap_b={cap_b} "
            f"n_match={nm} S={ls.launch_plan(max(cap_b, rows), p, sms)['s']}")
    for name, (q, res, cold, warm) in results.items():
        log(f"{name}: cold_s={cold!r} warm_s={warm!r} "
            f"lineitem_rows_per_s={LINEITEM_SF1_ROWS / warm!r}")

    def check(cpu: dict) -> None:
        for q in SEMI_LOCAL_QIDS:
            rows, cpu_s = cpu[QUERIES[q]]
            if not rows:
                raise AssertionError(f"q{q}: the CPU reference returned no rows")
            for name in (f"q{q}_local", f"q{q}_mesh"):
                if name in results:
                    rows_match(results[name][1].rows, rows, float_rtol=DOUBLE_RTOL)
            log(f"q{q}: local{' and mesh' if q in SEMI_MESH_QIDS else ''} match the CPU run "
                f"({len(rows)} rows, cpu wall_s={cpu_s!r}); first row {rows[0]}")

    return {"launches": launches, "check": check}


# -- phase 5c: the scalar functions and DISTINCT aggregates ---------------------


def shape_recording_probe(record: dict):
    """A stand-in for the mesh's call of the sorted-probe wrapper that passes
    every call through (the wrapper alone counts the launch), notes each
    launch's (P, cap_b, n_match, S) under record["query"] in
    record["shapes"], and keeps copies of the inputs of the largest launch
    in record["largest"].  n_match is a host read, so it runs only in the
    untimed capture runs."""
    import trino_tpu_torch.parallel.runner as mesh_runner
    from trino_tpu_torch.ops import locate_sorted as ls

    kernel = mesh_runner.locate_sorted
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def recording(build, n_match, probe, nomatch, cap_b):
        out = kernel(build, n_match, probe, nomatch, cap_b=cap_b)
        s = ls.launch_plan(max(cap_b, build.shape[0]), probe.shape[0], sms)["s"]
        record.setdefault("shapes", {}).setdefault(record["query"], []).append(
            (probe.shape[0], cap_b, int(n_match), s)
        )
        size = probe.shape[0] * max(build.shape[0], 1)
        if size > record.get("largest_size", -1):
            record.update(
                largest_size=size, largest_query=record["query"],
                largest=(build.clone(), n_match.clone(), probe.clone(),
                         nomatch.clone(), cap_b),
            )
        return out

    return kernel, recording


def like_table_seconds(runner, sql: str) -> list:
    """One untimed run of `sql` that times every LIKE/regexp table the host
    builds over a dictionary: [(dictionary entries, seconds)]."""
    from trino_tpu_torch.columnar.dictionary import StringDictionary

    original = StringDictionary.predicate_table
    calls = []

    def timed(self, fn):
        t0 = time.perf_counter()
        out = original(self, fn)
        calls.append((len(self), time.perf_counter() - t0))
        return out

    StringDictionary.predicate_table = timed
    try:
        runner.execute(sql)
    finally:
        StringDictionary.predicate_table = original
    return calls


def run_function_path(record: dict) -> dict:
    """Phase 5c: the twelve queries through the local runner on the card and
    on the 4-worker mesh, cold and warm, each checked against the port's
    CPU run at sf1.  Every mesh run of a query with a sorted-probe join
    must launch the kernel.  `record` receives each mesh query's launch
    shapes (an untimed capture run per query, after the count was read)."""
    import trino_tpu_torch.parallel.runner as mesh_runner
    from trino_tpu_torch.connectors.tpch.queries import QUERIES
    from trino_tpu_torch.ops import locate_sorted as ls
    from trino_tpu_torch.parallel.runner import DistributedQueryRunner
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    local = LocalQueryRunner(catalog="tpch", schema="sf1")
    mesh = DistributedQueryRunner(catalog="tpch", schema="sf1", n_workers=MESH_WORKERS)
    runs = [(f"q{q}_local", q, local) for q in FUNC_QIDS]
    runs += [(f"q{q}_mesh", q, mesh) for q in FUNC_QIDS]
    results = {}
    per_query = {}
    ls.locate_sorted.launches = 0  # every kernel count, just before the path
    for name, q, r in runs:
        walls = []
        for attempt in ("cold", "warm", "warm"):
            before = ls.locate_sorted.launches
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = r.execute(QUERIES[q])  # rows come back to the host
            wall = time.perf_counter() - t0
            walls.append(wall)
            launched = ls.locate_sorted.launches - before
            if r is mesh:
                per_query[q] = launched
                if q in FUNC_PROBE_QIDS and launched == 0:
                    raise AssertionError(f"{name} {attempt}: no locate_sorted launch")
            log(
                f"{name} {attempt}: wall_s={wall!r} "
                f"lineitem_rows_per_s={LINEITEM_SF1_ROWS / wall!r} "
                f"locate_sorted_launches={launched} "
                f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
                f"memory_allocated_after={torch.cuda.memory_allocated()} "
                f"rows={len(res.rows)}"
                + ("" if r is not mesh else f" mesh_events={r.last_stage_executor.counters}")
            )
        results[name] = (q, res, walls[0], min(walls[1:]))
    profile_warm("q13_local", local, QUERIES[13])
    for q in (9, 16):
        profile_warm(f"q{q}_mesh", mesh, QUERIES[q])
    launches = ls.locate_sorted.launches  # read just after the path
    log(f"function/distinct path: locate_sorted launches={launches}")
    if launches <= 0:
        raise AssertionError("the function/distinct path never launched locate_sorted")
    # untimed, after the count was read: each mesh query's launch shapes, and
    # the host time of Q13's LIKE table
    kernel, recording = shape_recording_probe(record)
    mesh_runner.locate_sorted = recording
    try:
        for q in FUNC_PROBE_QIDS:
            record["query"] = f"q{q}"
            mesh.execute(QUERIES[q])
    finally:
        mesh_runner.locate_sorted = kernel
    for q in FUNC_PROBE_QIDS:
        shapes = record.get("shapes", {}).get(f"q{q}", [])
        largest = max(shapes, key=lambda t: t[0] * max(t[1], 1), default=None)
        log(f"q{q}_mesh sorted-probe launches={per_query[q]} "
            f"largest (P, cap_b, n_match, S)={largest}")
    for runner_name, r in (("local", local), ("mesh", mesh)):
        calls = like_table_seconds(r, QUERIES[13])
        log(f"q13 {runner_name} LIKE tables on the host: calls={len(calls)} "
            f"dictionary_entries={[n for n, _ in calls]} "
            f"seconds={sum(t for _, t in calls)!r}")
        if not calls:
            raise AssertionError("q13 built no LIKE table")
    for name, (q, res, cold, warm) in results.items():
        log(f"{name}: cold_s={cold!r} warm_s={warm!r} "
            f"lineitem_rows_per_s={LINEITEM_SF1_ROWS / warm!r}")

    def check(cpu: dict) -> None:
        for q in FUNC_QIDS:
            rows, cpu_s = cpu[QUERIES[q]]
            if not rows:
                raise AssertionError(f"q{q}: the CPU reference returned no rows")
            for name in (f"q{q}_local", f"q{q}_mesh"):
                rows_match(results[name][1].rows, rows, float_rtol=DOUBLE_RTOL)
            log(f"q{q}: local and mesh match the CPU run ({len(rows)} rows, "
                f"cpu wall_s={cpu_s!r}); first row {rows[0]}")

    return {"launches": launches, "per_query": per_query, "check": check}


# -- phase 5d: TPC-DS without windows -------------------------------------------


def tpcds_qids(windowed: bool = False) -> list:
    """Phase 5d's queries (no window function), or phase 5e's (the windowed
    queries the JAX package answers)."""
    from trino_tpu_torch.connectors.tpcds.queries import QUERIES

    return [
        q for q in sorted(QUERIES)
        if (q in TPCDS_WINDOW_QIDS) == windowed and q not in TPCDS_RAISING
    ]


def _pin_to_cores(upper: bool, share: int = 1) -> str:
    """Pin this process to one half of its cores (the CPU reference
    processes take the upper half, the main card process the lower), with
    torch's threads to match, split among the `share` processes that take
    the same half; on fewer than four cores nothing is pinned."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 4:
        return f"not pinned ({len(cores)} cores)"
    half = len(cores) // 2
    mine = cores[half:] if upper else cores[:half]
    os.sched_setaffinity(0, mine)
    torch.set_num_threads(max(len(mine) // share, 1))
    return f"cores {mine[0]}-{mine[-1]}, {torch.get_num_threads()} torch threads"


#: the CPU reference processes, each with the phases whose CPU runs it
#: makes, in this order: "tpcds" those of phases 5d and 5e (which the
#: second card process runs), "rest" every other phase's, the phases the
#: card reaches last first, so it has work while phase 5f's budgets are
#: not yet written
REFERENCE_PARTS = {
    "tpcds": ("5d", "5e"),
    "rest": ("5k", "5l", "tpch", "5f", "5g", "5h", "5i", "5j", "5p"),
}
#: each phase's result file, beside the reference path
REFERENCE_SUFFIX = {
    "5d": "", "5e": ".window", "5f": ".memory", "5g": ".arrays", "5h": ".aggregates",
    "5i": ".holistic", "5j": ".temporal", "5k": ".statements", "5l": ".lifecycle",
    "tpch": ".tpch", "5p": ".multihost",
}


def tpcds_cpu_reference(out_path: str, windowed: bool, runners: dict) -> None:
    """The port's CPU run (device="cpu") of every phase 5d query (or,
    `windowed`, every phase 5e query), pickled to `out_path` + the phase's
    suffix as {qid: (column names, type names, rows, seconds, the query's
    ORDER BY and LIMIT, host planning seconds)}."""
    import pickle

    from trino_tpu_torch.connectors.tpcds.queries import QUERIES
    from trino_tpu_torch.runtime.runner import LocalQueryRunner
    from trino_tpu_torch.testing import result_order

    out = {}
    for q in tpcds_qids(windowed):
        schema = TPCDS_SCHEMA.get(q, "sf1")
        if schema not in runners:
            runners[schema] = LocalQueryRunner(catalog="tpcds", schema=schema, device="cpu")
        t0 = time.perf_counter()
        order = result_order(runners[schema].create_plan(QUERIES[q]))
        plan_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = runners[schema].execute(QUERIES[q])
        out[q] = (res.column_names, [t.name for t in res.types], res.rows,
                  time.perf_counter() - t0, order, plan_s)
    path = out_path + REFERENCE_SUFFIX["5e" if windowed else "5d"]
    with open(path + ".part", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".part", path)


def cpu_reference(part: str, out_path: str) -> int:
    """A reference process: the port's CPU run of each phase of
    REFERENCE_PARTS[part], in order, each pickled beside `out_path` as soon
    as it is made.  It runs beside the card phases, on the upper half of
    the cores; if it fails, it leaves `out_path` + ".failed" for the second
    card process to see."""
    start = time.perf_counter()
    log(f"cpu reference ({part}): {_pin_to_cores(upper=True, share=len(REFERENCE_PARTS))}")
    runners: dict = {}
    makers = {
        "5d": lambda path: tpcds_cpu_reference(path, False, runners),
        "5e": lambda path: tpcds_cpu_reference(path, True, runners),
        "5f": memory_cpu_reference, "5g": arrays_cpu_reference,
        "5h": aggregates_cpu_reference, "5i": holistic_cpu_reference,
        "5j": temporal_cpu_reference, "5k": statements_cpu_reference,
        "5l": lifecycle_cpu_reference, "tpch": tpch_cpu_reference,
        "5p": multihost_cpu_reference,
    }
    try:
        for phase in REFERENCE_PARTS[part]:
            makers[phase](out_path)
            log(f"cpu reference ({part}): phase {phase} written "
                f"{time.perf_counter() - start:.1f} s after the process started")
    except BaseException:
        with open(out_path + ".failed", "w") as f:
            f.write(part)
        raise
    return 0


def tpch_reference_sqls() -> list:
    """The statements phases 4-5c, 5m's M1 and 5p (its Q1, Q3, Q18 and
    Q1-double) hold to the port's CPU run, each once."""
    from trino_tpu_torch.connectors.tpch.queries import QUERIES

    sqls = [QUERIES[1], QUERIES[6], Q1_DOUBLE, QUERIES[3]]
    sqls += [QUERIES[q] for q in SEMI_LOCAL_QIDS + FUNC_QIDS + LICENSE_QIDS]
    return list(dict.fromkeys(sqls))


def tpch_cpu_reference(out_path: str) -> None:
    """The CPU run of every statement of phases 4-5c, pickled to `out_path`
    + ".tpch" as {sql: (rows, seconds)}."""
    import pickle

    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    t_part = time.perf_counter()
    cpu = LocalQueryRunner(catalog="tpch", schema="sf1", device="cpu")
    out = {}
    for sql in tpch_reference_sqls():
        t0 = time.perf_counter()
        rows = cpu.execute(sql).rows
        out[sql] = (rows, time.perf_counter() - t0)
    path = out_path + REFERENCE_SUFFIX["tpch"]
    with open(path + ".part", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".part", path)
    log(f"tpch cpu reference (4-5c): {time.perf_counter() - t_part:.1f} s of CPU work")


def start_references(here: str):
    """Start the CPU reference processes; returns ({part: process}, the
    result path, in a temporary directory of its own)."""
    import tempfile

    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_"), "reference.pkl")
    procs = {
        part: subprocess.Popen(
            [sys.executable, os.path.join(here, "chip_smoke.py"), "--cpu-reference", part, path],
            cwd=here,
        )
        for part in REFERENCE_PARTS
    }
    return procs, path


def wait_reference(procs: dict, path: str, phase: str) -> dict:
    """The CPU results of `phase` (a key of REFERENCE_SUFFIX) as soon as its
    reference process has written them; after that process's last phase,
    the process has ended."""
    import pickle

    part = next(p for p, phases in REFERENCE_PARTS.items() if phase in phases)
    proc = procs[part]
    t0 = time.perf_counter()
    path += REFERENCE_SUFFIX[phase]
    while not os.path.exists(path) and proc.poll() is None:
        time.sleep(0.5)
    rc = proc.wait() if phase == REFERENCE_PARTS[part][-1] else (proc.poll() or 0)
    log(f"cpu reference ({phase}): exit {rc}, waited {time.perf_counter() - t0:.1f} s")
    if rc != 0 or not os.path.exists(path):
        raise AssertionError(f"the CPU reference process ({part}) failed with exit code {rc}")
    with open(path, "rb") as f:
        return pickle.load(f)


def read_reference(path: str, phase: str) -> dict:
    """In the second card process: the CPU results of `phase` as soon as
    they are written; it stops if a reference process failed or the main
    process has ended."""
    import pickle

    parent = os.getppid()
    t0 = time.perf_counter()
    target = path + REFERENCE_SUFFIX[phase]
    while not os.path.exists(target):
        if os.path.exists(path + ".failed"):
            raise AssertionError("a CPU reference process failed")
        if os.getppid() != parent:
            raise SystemExit("chip_smoke: the main process has ended")
        time.sleep(0.5)
    log(f"cpu reference ({phase}): read by the tpcds card process, "
        f"waited {time.perf_counter() - t0:.1f} s")
    with open(target, "rb") as f:
        return pickle.load(f)


def tpcds_card_process(out_path: str, reference_path: str) -> int:
    """The second card process: phases 5d and 5e, beside the main process's
    other phases and on its cores, each result checked here against the
    reference's CPU run.  What the main process needs of them (each phase's
    launches and per-query counts, the inputs of its largest sorted-probe
    launch, its seconds) is pickled to `out_path`."""
    import pickle

    cores = sorted(os.sched_getaffinity(0))
    torch.set_num_threads(max(len(cores) // 2, 1))
    log(f"tpcds card process: cores {cores[0]}-{cores[-1]}, "
        f"{torch.get_num_threads()} torch threads")

    def reference(phase):
        return read_reference(reference_path, phase)

    out = {}
    for phase, windowed in (("5d", False), ("5e", True)):
        record: dict = {}
        t0 = time.perf_counter()
        path = (run_tpcds_window_path(record, reference) if windowed
                else run_tpcds_path(record, reference))
        seconds = time.perf_counter() - t0
        kept = {k: record[k] for k in ("largest_query", "largest") if k in record}
        if "largest" in kept:  # to the host: the main process takes them back
            kept["largest"] = tuple(x.cpu() if isinstance(x, torch.Tensor) else x
                                    for x in kept["largest"])
        out[phase] = {"path": path, "record": kept, "seconds": seconds}
    with open(out_path + ".part", "wb") as f:
        pickle.dump(out, f)
    os.replace(out_path + ".part", out_path)
    return 0


def start_tpcds_card(here: str, reference_path: str):
    """Start the second card process; returns (process, its result path)."""
    out_path = reference_path + ".card"
    proc = subprocess.Popen(
        [sys.executable, os.path.join(here, "chip_smoke.py"), "--tpcds-card", out_path,
         reference_path],
        cwd=here,
    )
    return proc, out_path


def wait_tpcds_card(proc, out_path: str, procs: dict, dev) -> dict:
    """Phases 5d and 5e's results from the second card process once it and
    both reference processes have ended (their largest launches' inputs
    back on the card); fails if any of them failed."""
    import pickle

    t0 = time.perf_counter()
    while proc.poll() is None:
        for part, p in procs.items():
            if p.poll() not in (None, 0):
                raise AssertionError(f"the CPU reference process ({part}) failed "
                                     f"with exit code {p.returncode}")
        time.sleep(0.5)
    log(f"tpcds card process: exit {proc.returncode}, waited {time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0 or not os.path.exists(out_path):
        raise AssertionError(f"the tpcds card process failed with exit code {proc.returncode}")
    for part, p in procs.items():
        if p.wait() != 0:
            raise AssertionError(f"the CPU reference process ({part}) failed "
                                 f"with exit code {p.returncode}")
    with open(out_path, "rb") as f:
        out = pickle.load(f)
    for phase in out.values():
        if "largest" in phase["record"]:
            phase["record"]["largest"] = tuple(
                x.to(dev) if isinstance(x, torch.Tensor) else x
                for x in phase["record"]["largest"]
            )
    return out


def eligibility_recording_search(record: dict):
    """(original, stand-in) for StageExecutor._probe_search: the stand-in's
    search counts, in record["eligible"], every call whose key planes the
    sorted-probe kernel takes (`probe_kernel_eligible`, the routing's own
    predicate), then searches as before.  On the card every such call must
    launch the kernel."""
    from trino_tpu_torch.ops.locate_sorted import probe_kernel_eligible
    from trino_tpu_torch.parallel.runner import StageExecutor

    original = StageExecutor._probe_search

    def probe_search(self):
        search, use_kernel = original(self)

        def counted(canon, n_match, pc, pn, cap_b: int):
            if probe_kernel_eligible(canon, pc):
                record["eligible"] = record.get("eligible", 0) + 1
            return search(canon, n_match, pc, pn, cap_b)

        return counted, use_kernel

    return original, probe_search


#: the TPC-DS runners of phases 5d and 5e, by (where, schema)
_TPCDS_RUNNERS: dict = {}


def tpcds_runner(where: str, schema: str):
    from trino_tpu_torch.parallel.runner import DistributedQueryRunner
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    if (where, schema) not in _TPCDS_RUNNERS:
        _TPCDS_RUNNERS[where, schema] = (
            LocalQueryRunner(catalog="tpcds", schema=schema) if where == "local"
            else DistributedQueryRunner(catalog="tpcds", schema=schema, n_workers=MESH_WORKERS)
        )
    return _TPCDS_RUNNERS[where, schema]


def run_tpcds_path(record: dict, reference, windowed: bool = False, windows=None) -> dict:
    """Phase 5d (or, `windowed`, 5e): its TPC-DS queries through the local
    runner on the card and on the 4-worker mesh (default knobs), cold and
    warm, each held to the port's CPU run (the reference process).  The
    cold mesh run of each query records its sorted-probe launches' shapes
    and keeps the inputs of the largest (one host read per launch); with
    `windows`, the cold runs also record every window step's input.  Every
    mesh search whose key planes the kernel takes must launch it: each mesh
    run launches at least as many times as it made such searches, and a
    query with one launches at least once."""
    from trino_tpu_torch.ops import locate_sorted as ls
    from trino_tpu_torch.parallel.runner import StageExecutor
    from trino_tpu_torch.testing import assert_rows_match

    label = "tpcds window" if windowed else "tpcds"
    qids = tpcds_qids(windowed)
    kernel, recording = shape_recording_probe(record)
    original_search, eligible_search = eligibility_recording_search(record)
    results = {}
    per_query = {}
    log(f"{label}: {len(qids)} queries, local and mesh; at sf0_1 only: "
        f"{sorted(set(TPCDS_SCHEMA) & set(qids))} (see TPCDS_SCHEMA)")
    StageExecutor._probe_search = eligible_search
    try:
        _tpcds_runs(qids, record, results, per_query, kernel, recording, windows)
    finally:
        StageExecutor._probe_search = original_search
    launches = ls.locate_sorted.launches  # read just after the path
    log(f"{label} path: locate_sorted launches={launches}")
    if launches <= 0:
        raise AssertionError(f"the {label} path never launched locate_sorted")
    for q in qids:
        shapes = record.get("shapes", {}).get(f"q{q}", [])
        largest = max(shapes, key=lambda t: t[0] * max(t[1], 1), default=None)
        log(f"{label} q{q}_mesh sorted-probe launches={per_query[q]} "
            f"largest (P, cap_b, n_match, S)={largest}")
    for (q, where), (res, cold, warm) in results.items():
        log(f"{label} q{q}_{where}: cold_s={cold!r} warm_s={warm!r} rows={len(res.rows)}")
    expected_all = reference("5e" if windowed else "5d")
    empty = []
    for q in qids:
        names, types, rows, cpu_s, order, plan_s = expected_all[q]
        for where in ("local", "mesh"):
            actual = results[q, where][0]
            if actual.column_names != names or [t.name for t in actual.types] != types:
                raise AssertionError(f"{label} q{q}_{where}: columns differ from the CPU run")
            try:
                assert_rows_match(actual.rows, rows, order, float_rtol=DOUBLE_RTOL)
            except AssertionError as e:
                raise AssertionError(f"{label} q{q}_{where}: {e}") from None
        if not rows:
            empty.append(q)
        log(f"{label} q{q}: local and mesh match the CPU run ({len(rows)} rows, "
            f"cpu wall_s={cpu_s!r}, cpu plan_s={plan_s!r})")
    log(f"{label}: all {len(qids)} queries match the CPU run, local and mesh; "
        f"empty results: {empty}")
    return {"launches": launches, "per_query": per_query}


def _tpcds_runs(qids, record, results, per_query, kernel, recording, windows) -> None:
    """The timed runs of phase 5d or 5e, each cold and warm: first the
    queries that run below sf1 (TPCDS_SCHEMA), local then mesh, whose mesh
    run takes most of the card's memory while the main card process is in
    its first, small phases, and whose cache is then given back; then every
    other query local, then mesh; phase 5d's profiled warm runs follow."""
    import trino_tpu_torch.parallel.runner as mesh_runner
    from trino_tpu_torch.connectors.tpcds.queries import QUERIES
    from trino_tpu_torch.ops import locate_sorted as ls

    below = [q for q in qids if q in TPCDS_SCHEMA]
    runs = [(where, q) for q in below for where in ("local", "mesh")]
    runs += [(where, q) for where in ("local", "mesh") for q in qids if q not in below]
    ls.locate_sorted.launches = 0  # every kernel count, just before the path
    for i, (where, q) in enumerate(runs):
        if i == 2 * len(below) > 0:
            torch.cuda.empty_cache()  # the card's memory back for the other process
        schema = TPCDS_SCHEMA.get(q, "sf1")
        r = tpcds_runner(where, schema)
        walls = []
        for attempt in ("cold", "warm"):
            capture = where == "mesh" and attempt == "cold"
            if capture:
                record["query"] = f"q{q}"
                mesh_runner.locate_sorted = recording
            if windows is not None:
                windows["query"] = (q, where) if attempt == "cold" else None
            before = ls.locate_sorted.launches
            eligible_before = record.get("eligible", 0)
            torch.cuda.reset_peak_memory_stats()
            try:
                t0 = time.perf_counter()
                res = r.execute(QUERIES[q])  # rows come back to the host
                wall = time.perf_counter() - t0
            finally:
                mesh_runner.locate_sorted = kernel
                if windows is not None:
                    windows["query"] = None
            walls.append(wall)
            launched = ls.locate_sorted.launches - before
            eligible = record.get("eligible", 0) - eligible_before
            if where == "mesh":
                per_query[q] = launched
                if launched < eligible or (eligible and not launched):
                    raise AssertionError(
                        f"q{q} mesh {attempt}: {eligible} searches the sorted-probe "
                        f"kernel takes, {launched} launches"
                    )
            log(
                f"tpcds q{q}_{where} {attempt} ({schema}): wall_s={wall!r} "
                f"locate_sorted_launches={launched} kernel_eligible_searches={eligible} "
                f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
                f"memory_allocated_after={torch.cuda.memory_allocated()} "
                f"rows={len(res.rows)}"
            )
        results[q, where] = (res, walls[0], walls[1])
    if windows is None:
        for q, where in TPCDS_PROFILES:
            profile_warm(
                f"tpcds_q{q}_{where}", tpcds_runner(where, TPCDS_SCHEMA.get(q, "sf1")),
                QUERIES[q],
            )


# -- phase 5e: TPC-DS with windows ----------------------------------------------


def window_recording_step(windows: dict):
    """(original, stand-in) for WindowOperator._window_step: while
    windows["query"] names a (query, where) run, the stand-in notes, for
    every step, its operator (one WindowNode; on the mesh each worker's
    shard is one step), the live input rows and capacity (host reads), and
    the long-decimal sum/avg paths it took (licensed "proven" or "limb")."""
    from trino_tpu_torch.ops.aggregation import DECIMAL_FASTPATH
    from trino_tpu_torch.ops.window import WindowOperator

    original = WindowOperator._window_step

    def step(self, batch):
        key = windows.get("query")
        if key is None:
            return original(self, batch)
        before = dict(DECIMAL_FASTPATH)
        out = original(self, batch)
        paths = {k: v - before.get(k, 0) for k, v in DECIMAL_FASTPATH.items()
                 if v != before.get(k, 0)}
        if not hasattr(self, "smoke_node"):
            self.smoke_node = windows["nodes"] = windows.get("nodes", 0) + 1
        windows.setdefault(key, {}).setdefault(self.smoke_node, []).append(
            (int(batch.count()), batch.capacity, paths)
        )
        return out

    return original, step


def run_tpcds_window_path(record: dict, reference) -> dict:
    """Phase 5e: the windowed TPC-DS queries the JAX package answers, as
    phase 5d runs its queries, with every window step's input logged (input
    rows, the largest worker's rows on the mesh, the long-decimal paths);
    one profiled warm mesh run of the query with the largest window input;
    q51 must raise the JAX package's NotImplementedError, local and mesh."""
    from trino_tpu_torch.connectors.tpcds.queries import QUERIES
    from trino_tpu_torch.ops.window import WindowOperator

    windows: dict = {"query": None}
    original, step = window_recording_step(windows)
    WindowOperator._window_step = step
    try:
        out = run_tpcds_path(record, reference, windowed=True, windows=windows)
    finally:
        WindowOperator._window_step = original
    input_rows = {}
    for q in tpcds_qids(windowed=True):
        for where in ("local", "mesh"):
            nodes = windows.get((q, where), {})
            if not nodes:
                raise AssertionError(f"tpcds window q{q}_{where}: no window step ran")
            for i, (node, steps) in enumerate(sorted(nodes.items())):
                rows = [n for n, _, _ in steps]
                paths = {}
                for _, _, p in steps:
                    for k, v in p.items():
                        paths[k] = paths.get(k, 0) + v
                log(f"tpcds window q{q}_{where} node {i}: input_rows={sum(rows)} "
                    f"steps={len(steps)} rows_per_step={rows} "
                    f"largest_step_rows={max(rows)} capacities={[c for _, c, _ in steps]} "
                    f"long_decimal_paths={paths or 'none'}")
                if where == "local":
                    input_rows[q] = max(input_rows.get(q, 0), sum(rows))
    largest = max(input_rows, key=input_rows.get)
    log(f"tpcds window: the largest window input is q{largest}'s "
        f"({input_rows[largest]} rows into one window step; predicted q67)")
    profile_warm(f"tpcds_window_q{largest}_mesh", tpcds_runner("mesh", "sf1"), QUERIES[largest])
    for q, message in TPCDS_RAISING.items():
        for where in ("local", "mesh"):
            try:
                tpcds_runner(where, "sf1").execute(QUERIES[q])
            except NotImplementedError as e:
                if str(e) != message:
                    raise AssertionError(f"tpcds q{q}_{where} raised {e!r}") from None
                log(f"tpcds q{q}_{where}: raised NotImplementedError({message!r}) "
                    f"as the JAX package does")
            else:
                raise AssertionError(f"tpcds q{q}_{where}: ran; the JAX package raises")
    out["largest_window_query"] = largest
    return out


# -- phase 5f: memory budgets, partition waves and spill -----------------------

MEMORY_JOIN = (
    "select o_orderpriority, count(*) c from orders join lineitem "
    "on o_orderkey = l_orderkey group by o_orderpriority"
)
MEMORY_AGG = "select l_orderkey, count(*), sum(l_quantity) from lineitem group by l_orderkey"
MEMORY_SORT = "select o_orderkey, o_totalprice from orders order by o_totalprice desc, o_orderkey"
MEMORY_OPERATORS = ("join", "aggregation", "window", "sort")
#: each budget is this fraction of the query's unbudgeted footprint, so the
#: automatic wave count comes out near 4
MEMORY_BUDGET_FRACTION = 4


def memory_queries() -> list:
    """Phase 5f's queries: (name, catalog, sql, on the mesh, the operators
    whose waves must rise under the budget)."""
    from trino_tpu_torch.connectors.tpcds.queries import QUERIES as TPCDS
    from trino_tpu_torch.connectors.tpch.queries import QUERIES as TPCH

    return [
        ("join_local", "tpch", MEMORY_JOIN, False, ("join",)),
        ("agg_local", "tpch", MEMORY_AGG, False, ("aggregation",)),
        ("q18_local", "tpch", TPCH[18], False, ()),
        ("sort_local", "tpch", MEMORY_SORT, False, ("sort",)),
        ("q67_local", "tpcds", TPCDS[67], False, ("window",)),
        ("join_mesh", "tpch", MEMORY_JOIN, True, ("join",)),
        ("agg_mesh", "tpch", MEMORY_AGG, True, ("aggregation",)),
        ("q3_mesh", "tpch", TPCH[3], True, ("join",)),
    ]


def pressure() -> dict:
    """The memory-pressure counters: waves per operator, spill bytes,
    revocations."""
    from trino_tpu_torch.telemetry import metrics

    out = {op: metrics.memory_waves_counter().value((op,)) for op in MEMORY_OPERATORS}
    out["spill_bytes"] = metrics.spill_bytes_counter().value()
    out["revocations"] = metrics.memory_revocations_counter().value()
    return out


def host_boundary_timers(seconds: dict):
    """Stand-ins that time the spill tier's host work: the row hashing and
    partitioning (serde.partition_batches, spill.host_wave_slice) and the
    copies off the card (spill.pull_host).  Returns a function that puts
    the originals back."""
    from trino_tpu_torch.parallel import serde
    from trino_tpu_torch.runtime import spill

    originals = []

    def wrap(module, name, bucket):
        fn = getattr(module, name)
        originals.append((module, name, fn))

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                seconds[bucket] = seconds.get(bucket, 0.0) + time.perf_counter() - t0

        setattr(module, name, timed)

    wrap(serde, "partition_batches", "partition_s")
    wrap(spill, "host_wave_slice", "partition_s")
    wrap(spill, "pull_host", "pull_host_s")

    def restore():
        for module, name, fn in originals:
            setattr(module, name, fn)

    return restore


def window_input_bytes(record: dict):
    """(original, stand-in) for WindowOperator.process: the stand-in adds
    the bytes of every batch a window consumes to record["bytes"]."""
    from trino_tpu_torch.ops.window import WindowOperator
    from trino_tpu_torch.runtime.memory import batch_bytes

    original = WindowOperator.process

    def process(self, stream):
        seen: set = set()

        def counted():
            for b in stream:
                record["bytes"] = record.get("bytes", 0) + batch_bytes(b, _seen_dicts=seen)
                yield b

        return original(self, counted())

    return original, process


def wave_recorder(waves: list):
    """(original, stand-in) for StageExecutor._sized_expansion: the
    stand-in notes, for every wave of a mesh wave join, the sorted-probe
    kernel's launches in that wave's expansion and the shapes of those
    launches [(P, cap_b, n_match on the card, S)] (n_match is read after
    the run, so the run is not synchronized for it)."""
    import trino_tpu_torch.parallel.runner as mesh_runner
    from trino_tpu_torch.ops import locate_sorted as ls
    from trino_tpu_torch.parallel.runner import StageExecutor

    original = StageExecutor._sized_expansion
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def sized(self, key, *args, **kw):
        if key[0] != "join_wave":
            return original(self, key, *args, **kw)
        kernel = mesh_runner.locate_sorted
        shapes = []

        def recording(build, n_match, probe, nomatch, cap_b):
            s = ls.launch_plan(max(cap_b, build.shape[0]), probe.shape[0], sms)["s"]
            shapes.append((probe.shape[0], cap_b, n_match, s))
            return kernel(build, n_match, probe, nomatch, cap_b=cap_b)

        before = ls.locate_sorted.launches
        mesh_runner.locate_sorted = recording
        try:
            out = original(self, key, *args, **kw)
        finally:
            mesh_runner.locate_sorted = kernel
        waves.append((ls.locate_sorted.launches - before, shapes))
        return out

    return original, sized


def memory_run(name, r, sql, label, spill_dir, budgeted, must_wave, mesh,
               spill_on=True, expect=None, order=None, waves=None):
    """One phase 5f run on the card: wall, rows, the statement's reserved
    peak, the peak working set above the starting allocation, the waves,
    spill bytes and revocations it added, and the host seconds of
    partitioning and of copies off the card.  An unbudgeted run must record
    no pressure; a budgeted one must wave (each operator of `must_wave`),
    spill exactly when spill is on and a spilling wave path ran, and (with
    `waves`) launch the sorted-probe kernel in every mesh join wave.  No
    run may leave a spill file or a live revocable."""
    from trino_tpu_torch.ops import locate_sorted as ls
    from trino_tpu_torch.runtime.spill import REVOCABLES
    from trino_tpu_torch.testing import assert_rows_match

    before = pressure()
    host: dict = {}
    restore = host_boundary_timers(host)
    k2_before = ls.locate_sorted.launches
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        res = r.execute(sql)  # rows come back to the host: synchronized
    finally:
        restore()
    wall = time.perf_counter() - t0
    peak_ws = torch.cuda.max_memory_allocated() - start
    delta = {k: v - before[k] for k, v in pressure().items()}
    left = os.listdir(spill_dir)
    if left or REVOCABLES.live():
        raise AssertionError(f"{name} {label}: left spill files {left} "
                             f"or live revocables {REVOCABLES.live()}")
    k = {op: delta[op] for op in MEMORY_OPERATORS if delta[op]}
    log(f"memory {name} {label}: wall_s={wall!r} rows={len(res.rows)} "
        f"reserved_peak_bytes={r.last_query.peak_memory} peak_working_set_bytes={peak_ws} "
        f"waves={k} spill_bytes={delta['spill_bytes']} revocations={delta['revocations']} "
        f"partition_host_s={host.get('partition_s', 0.0)!r} "
        f"pull_host_s={host.get('pull_host_s', 0.0)!r} "
        f"locate_sorted_launches={ls.locate_sorted.launches - k2_before}"
        + (f" mesh_events={r.last_stage_executor.counters}" if mesh else ""))
    if not budgeted:
        if any(delta.values()):
            raise AssertionError(f"{name} {label}: an unbudgeted run recorded {delta}")
    else:
        if not k:
            raise AssertionError(f"{name} {label}: the budget forced no waves")
        for op in must_wave:
            if not delta[op]:
                raise AssertionError(f"{name} {label}: no {op} waves under the budget")
        # every wave path spills but the mesh aggregation's exchange, whose
        # waves filter the states on the card
        spills = spill_on and bool(delta["join"] if mesh else k)
        if spills != (delta["spill_bytes"] > 0):
            raise AssertionError(
                f"{name} {label}: spill_bytes={delta['spill_bytes']} with spill "
                f"{'on' if spill_on else 'off'} and waves {k}"
            )
    if waves is not None:
        per_wave = [n for n, _ in waves]
        if not per_wave or min(per_wave) < 1:
            raise AssertionError(f"{name} {label}: the wave expansions launched "
                                 f"the sorted-probe kernel {per_wave} times")
        log(f"memory {name} {label}: sorted-probe launches per wave {per_wave}; "
            f"launch shapes (P, cap_b, n_match, S) per wave "
            f"{[[(p, c, int(nm), s) for p, c, nm, s in shapes] for _, shapes in waves]}")
    if expect is not None:
        assert_rows_match(res.rows, expect, order, float_rtol=DOUBLE_RTOL)
    return {"res": res, "wall": wall, "peak_ws": peak_ws, "delta": delta, "host": host}


def memory_runner(catalog: str, mesh: bool, **props):
    from trino_tpu_torch.parallel.runner import DistributedQueryRunner
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    r = (
        DistributedQueryRunner(catalog=catalog, schema="sf1", n_workers=MESH_WORKERS)
        if mesh else LocalQueryRunner(catalog=catalog, schema="sf1")
    )
    for k, v in props.items():
        r.properties.set(k, v)
    return r


def memory_cpu_reference(out_path: str) -> None:
    """The reference process's phase 5f part: once the card process has
    written the budgets, the port's CPU LocalQueryRunner runs every phase 5f
    query under its budget (a mesh query's budget on the local runner),
    pickled to `out_path` + ".memory" as {name: (rows, seconds, the
    pressure it recorded)}."""
    import json as _json
    import pickle
    import shutil
    import tempfile

    from trino_tpu_torch import config
    from trino_tpu_torch.runtime.runner import LocalQueryRunner
    from trino_tpu_torch.runtime.spill import REVOCABLES

    budgets_path = out_path + ".budgets"
    while not os.path.exists(budgets_path):
        time.sleep(0.5)
    with open(budgets_path) as f:
        budgets = _json.load(f)
    spill_dir = tempfile.mkdtemp(prefix="chip_smoke_cpu_spill_")
    config.install_config(config.load_cluster_config({"memory.spill-dir": spill_dir}))
    out = {}
    for name, catalog, sql, _, _ in memory_queries():
        cpu = LocalQueryRunner(catalog=catalog, schema="sf1", device="cpu")
        cpu.properties.set("query_max_memory", budgets[name])
        before = pressure()
        t0 = time.perf_counter()
        rows = cpu.execute(sql).rows
        seconds = time.perf_counter() - t0
        if os.listdir(spill_dir) or REVOCABLES.live():
            raise AssertionError(f"memory {name} cpu: spill files or revocables left")
        out[name] = (rows, seconds, {k: v - before[k] for k, v in pressure().items()})
    config.reset_config()
    shutil.rmtree(spill_dir, ignore_errors=True)
    with open(out_path + ".memory.part", "wb") as f:
        pickle.dump(out, f)
    os.replace(out_path + ".memory.part", out_path + ".memory")


def run_memory_path(reference, budgets_path: str) -> dict:
    """Phase 5f: the memory budgets on the card.  Five local queries and
    three on the 4-worker mesh, each unbudgeted (cold, warm), which gives
    its footprint and so its budget (written to `budgets_path` for the
    reference process's CPU runs), then under the budget with spill to
    disk; the local join also with spill off, with two waves pinned, and
    revoked mid-probe by a shrinking pool limit; one profiled warm
    budgeted run each of the local and the mesh join; last, every
    budgeted result against the CPU run under the same budget."""
    import shutil
    import tempfile

    from trino_tpu_torch import config
    from trino_tpu_torch.ops import locate_sorted as ls
    from trino_tpu_torch.ops.join import HashJoinOperator
    from trino_tpu_torch.ops.window import WindowOperator
    from trino_tpu_torch.parallel.runner import StageExecutor
    from trino_tpu_torch.runtime.lifecycle import set_memory_pool_limit
    from trino_tpu_torch.testing import assert_rows_match, result_order

    spill_dir = tempfile.mkdtemp(prefix="chip_smoke_spill_")
    config.install_config(config.load_cluster_config({"memory.spill-dir": spill_dir}))
    queries = {q[0]: q for q in memory_queries()}
    plain: dict = {}
    table: dict = {}
    ls.locate_sorted.launches = 0  # every kernel count, just before the path
    try:
        # unbudgeted, cold and warm: the rows every budgeted run must give,
        # and the footprint (q67's window reserves nothing, so its input
        # counts as its wave path would need it: twice its bytes)
        for name, (_, catalog, sql, mesh, _) in queries.items():
            r = memory_runner(catalog, mesh)
            order = result_order(r.create_plan(sql))
            window: dict = {}
            original, counting = window_input_bytes(window)
            WindowOperator.process = counting
            try:
                cold = memory_run(name, r, sql, "unbudgeted cold", spill_dir, False, (), mesh)
            finally:
                WindowOperator.process = original
            warm = memory_run(name, r, sql, "unbudgeted warm", spill_dir, False, (), mesh)
            footprint = max(r.last_query.peak_memory, 2 * window.get("bytes", 0))
            budget = max(footprint // MEMORY_BUDGET_FRACTION, 1)
            log(f"memory {name}: footprint_bytes={footprint} (reserved peak "
                f"{r.last_query.peak_memory}, window input bytes {window.get('bytes', 0)}) "
                f"budget_bytes={budget}")
            plain[name] = {"rows": cold["res"].rows, "order": order, "warm": warm,
                           "footprint": footprint, "budget": budget}
        with open(budgets_path + ".part", "w") as f:
            json.dump({n: p["budget"] for n, p in plain.items()}, f)
        os.replace(budgets_path + ".part", budgets_path)

        # under the budget, spill to disk: one run after the two unbudgeted
        budgeted = {}
        for name, (_, catalog, sql, mesh, must_wave) in queries.items():
            p = plain[name]
            r = memory_runner(catalog, mesh, query_max_memory=p["budget"])
            waves: list = []
            record = mesh and "join" in must_wave
            if record:
                original, sized = wave_recorder(waves)
                StageExecutor._sized_expansion = sized
            try:
                run = memory_run(name, r, sql, "budgeted", spill_dir, True, must_wave, mesh,
                                 expect=p["rows"], order=p["order"],
                                 waves=waves if record else None)
            finally:
                if record:
                    StageExecutor._sized_expansion = original
            budgeted[name] = (r, run["res"].rows)
            table[name] = {
                "footprint_bytes": p["footprint"], "budget_bytes": p["budget"],
                "k": {op: run["delta"][op] for op in MEMORY_OPERATORS if run["delta"][op]},
                "spill_bytes": run["delta"]["spill_bytes"],
                "warm_s": run["wall"], "unbudgeted_warm_s": p["warm"]["wall"],
                "peak_working_set_bytes": run["peak_ws"],
                "unbudgeted_peak_working_set_bytes": p["warm"]["peak_ws"],
                "partition_host_s": run["host"].get("partition_s", 0.0),
                "pull_host_s": run["host"].get("pull_host_s", 0.0),
                "rows": len(run["res"].rows),
            }

        # the local join: spill off, two waves pinned, and revoked mid-probe
        join = plain["join_local"]

        def join_run(label, props, **kw):
            r = memory_runner("tpch", False, **props)
            return memory_run("join_local", r, MEMORY_JOIN, label, spill_dir, True, ("join",),
                              False, expect=join["rows"], order=join["order"], **kw)

        join_run("budgeted spill off", {"query_max_memory": join["budget"],
                                        "spill_enabled": False}, spill_on=False)
        if join_run("budgeted k=2", {"query_max_memory": join["budget"],
                                     "memory_wave_partitions": 2})["delta"]["join"] != 2:
            raise AssertionError("join_local k=2: not two join waves")
        # after the first probe batch the pool limit drops to half the
        # join's footprint, below its build's reservation: the aggregation
        # above it reserves next, and the revoke tier spills the build
        calls = []
        original_batch = HashJoinOperator._join_batch

        def tripping(self, pb):
            out = original_batch(self, pb)
            if not calls:
                set_memory_pool_limit(join["footprint"] // 2)
            calls.append(1)
            return out

        HashJoinOperator._join_batch = tripping
        try:
            revoked = join_run("revoked", {})
        finally:
            HashJoinOperator._join_batch = original_batch
            set_memory_pool_limit(0)
        if revoked["delta"]["revocations"] < 1:
            raise AssertionError("join_local revoked: no revocation")
        launches = ls.locate_sorted.launches  # read just after the path
        profile_warm("memory_join_local_budgeted", budgeted["join_local"][0], MEMORY_JOIN)
        profile_warm("memory_join_mesh_budgeted", budgeted["join_mesh"][0], MEMORY_JOIN)
    finally:
        config.reset_config()
        shutil.rmtree(spill_dir, ignore_errors=True)

    # the port's CPU run under each budget, from the reference process
    cpu = reference("5f")
    for name, (rows, seconds, cpu_pressure) in cpu.items():
        assert_rows_match(budgeted[name][1], rows, plain[name]["order"],
                          float_rtol=DOUBLE_RTOL)
        table[name]["cpu_s"] = seconds
        log(f"memory {name}: the card's rows match the CPU run under the same budget "
            f"({len(rows)} rows, cpu wall_s={seconds!r}, cpu pressure "
            f"{ {k: v for k, v in cpu_pressure.items() if v} })")
    log(f"memory path: locate_sorted launches={launches}")
    for name, row in table.items():
        log(f"memory table {name}: {json.dumps(row)}")
    return {"launches": launches, "table": table}


# -- phase 5g: arrays, maps and UNNEST --------------------------------------------


def arrays_cpu_reference(out_path: str) -> None:
    """The reference process's phase 5g part: the port's CPU run of every
    ARRAY_QUERIES query and of ARRAY_U4_TOTALS at tpch.sf1 (`pallas_agg`
    off: f64 sums), pickled to `out_path` + ".arrays" as {name: (column
    names, type names, rows, seconds, the ORDER BY and LIMIT)}."""
    import pickle

    from trino_tpu_torch.runtime.runner import LocalQueryRunner
    from trino_tpu_torch.testing import result_order

    cpu = LocalQueryRunner(catalog="tpch", schema="sf1", device="cpu")
    out = {}
    for name, sql in list(ARRAY_QUERIES.items()) + [("U4_totals", ARRAY_U4_TOTALS)]:
        order = result_order(cpu.create_plan(sql))
        t0 = time.perf_counter()
        res = cpu.execute(sql)
        out[name] = (res.column_names, [t.name for t in res.types], res.rows,
                     time.perf_counter() - t0, order)
    with open(out_path + ".arrays.part", "wb") as f:
        pickle.dump(out, f)
    os.replace(out_path + ".arrays.part", out_path + ".arrays")


def array_width_recorder(widths: dict):
    """(original, stand-in) for ExprCompiler.value: the stand-in counts, in
    `widths`, the element width K of every array or map value an
    expression builds (a map counts its key plane's K)."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.expr.compiler import ExprCompiler

    original = ExprCompiler.value

    def value(self, expr):
        v = original(self, expr)
        if v.lengths is not None:
            k = v.data.shape[-1] // (2 if isinstance(v.type, T.MapType) else 1)
            widths[k] = widths.get(k, 0) + 1
        return v

    return original, value


def gather_byte_recorder(moved: list):
    """(original, stand-in) for StageExecutor._remote_as_host: the stand-in
    passes every batch a gather or merge brings into the coordinator's
    local engine through as it streams, appending its bytes to `moved`."""
    from trino_tpu_torch.parallel.runner import StageExecutor
    from trino_tpu_torch.runtime.local_planner import PhysicalPlan
    from trino_tpu_torch.runtime.memory import batch_bytes

    original = StageExecutor._remote_as_host

    def remote_as_host(self, node):
        plan = original(self, node)
        seen: set = set()  # a dictionary shared by batches counts once

        def counted(stream):
            for b in stream:
                moved.append(batch_bytes(b, seen))
                yield b

        return PhysicalPlan(counted(plan.stream), plan.symbols)

    return original, remote_as_host


def grouped_sums_recorder(capture: dict):
    """(original, stand-in) for the grouped-sums wrapper's launch step
    (`ops.grouped_sums._launch`, reached only on the card): the stand-in
    passes every launch through (the wrapper alone counts it) and keeps
    copies of the inputs of the largest in capture["largest"]."""
    from trino_tpu_torch.ops import grouped_sums as gs

    original = gs._launch

    def recording(gids, mask, values, n_groups, plan):
        if values.numel() > capture.get("largest_size", -1):
            capture.update(largest_size=values.numel(),
                           largest=(gids.clone(), mask.clone(), values.clone(), n_groups))
        return original(gids, mask, values, n_groups, plan)

    return original, recording


def run_array_path(reference, probe_record: dict, k1_capture: dict) -> dict:
    """Phase 5g: ARRAY_QUERIES through the local runner and the 4-worker
    mesh on the card, cold and warm, each held to the reference process's
    CPU run.  The local U1 (with `pallas_agg` on) must launch the
    grouped-sums kernel and the mesh U2 the sorted-probe kernel.  The timed
    runs carry no instrument of the script's own; after the path's counts
    are read, one untimed capture run of each query and runner reads the
    K of every array value, the mesh gathers' bytes, and the kernels'
    inputs: the local U1's largest grouped-sums launch into `k1_capture`,
    the mesh U2's sorted-probe launch shapes and largest inputs into
    `probe_record`.  Last, the local U3 under a budget above its footprint
    and under a quarter of it (waves), each against its unbudgeted rows."""
    import shutil
    import tempfile

    import trino_tpu_torch.parallel.runner as mesh_runner
    from trino_tpu_torch import config
    from trino_tpu_torch.expr import arrays as array_fns
    from trino_tpu_torch.expr.compiler import ExprCompiler
    from trino_tpu_torch.ops import aggregation as agg
    from trino_tpu_torch.ops import grouped_sums as gs
    from trino_tpu_torch.ops import locate_sorted as ls
    from trino_tpu_torch.parallel.runner import DistributedQueryRunner, StageExecutor
    from trino_tpu_torch.runtime.runner import LocalQueryRunner
    from trino_tpu_torch.testing import assert_rows_match, result_order

    local = LocalQueryRunner(catalog="tpch", schema="sf1")
    kernel_local = LocalQueryRunner(catalog="tpch", schema="sf1")
    kernel_local.execute("set session pallas_agg = true")
    mesh = DistributedQueryRunner(catalog="tpch", schema="sf1", n_workers=MESH_WORKERS)

    def runner(name, where):
        return mesh if where == "mesh" else kernel_local if name == ARRAY_K1_QUERY else local

    results = {}
    gs.grouped_sums.launches = 0  # every kernel count, just before the path
    ls.locate_sorted.launches = 0
    for name, sql in ARRAY_QUERIES.items():
        for where in ("local", "mesh"):
            r = runner(name, where)
            walls = []
            for attempt in ("cold", "warm"):
                agg.COLLECT_LOG.clear()
                array_fns.SPLIT_TABLE_LOG.clear()
                k1, k2 = gs.grouped_sums.launches, ls.locate_sorted.launches
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                res = r.execute(sql)  # rows come back to the host
                wall = time.perf_counter() - t0
                walls.append(wall)
                k1 = gs.grouped_sums.launches - k1
                k2 = ls.locate_sorted.launches - k2
                if name == ARRAY_K1_QUERY and where == "local" and k1 == 0:
                    raise AssertionError(f"{name} local {attempt}: no grouped_sums launch")
                if name == ARRAY_K2_QUERY and where == "mesh" and k2 == 0:
                    raise AssertionError(f"{name} mesh {attempt}: no locate_sorted launch")
                log(
                    f"arrays {name}_{where} {attempt}: wall_s={wall!r} "
                    f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
                    f"width_host_reads={len(agg.COLLECT_LOG)} "
                    f"collect_widths={list(agg.COLLECT_LOG)} "
                    f"split_tables={list(array_fns.SPLIT_TABLE_LOG)} "
                    f"grouped_sums_launches={k1} locate_sorted_launches={k2} "
                    f"rows={len(res.rows)}"
                    + ("" if where == "local"
                       else f" mesh_events={r.last_stage_executor.counters}")
                )
            results[name, where] = (res, walls[0], walls[1])
    profile_warm("U1_local", kernel_local, ARRAY_QUERIES["U1"])
    profile_warm("U3_mesh", mesh, ARRAY_QUERIES["U3"])
    k1_launches = gs.grouped_sums.launches  # read just after the path
    k2_launches = ls.locate_sorted.launches
    log(f"array path: grouped_sums launches={k1_launches} "
        f"locate_sorted launches={k2_launches}")

    # untimed, after the counts were read: one capture run of each query
    # and runner, with the array widths, the gathers' bytes and the
    # kernels' inputs recorded
    widths: dict = {}
    gathered: list = []
    value_orig, value_rec = array_width_recorder(widths)
    remote_orig, remote_rec = gather_byte_recorder(gathered)
    gs_orig, gs_rec = grouped_sums_recorder(k1_capture)
    probe_kernel, probe_rec = shape_recording_probe(probe_record)
    k1_capture["query"] = probe_record["query"] = None
    ExprCompiler.value = value_rec
    StageExecutor._remote_as_host = remote_rec
    try:
        for name, sql in ARRAY_QUERIES.items():
            for where in ("local", "mesh"):
                widths.clear()
                gathered.clear()
                if name == ARRAY_K1_QUERY and where == "local":
                    k1_capture["query"] = name
                    gs._launch = gs_rec
                if name == ARRAY_K2_QUERY and where == "mesh":
                    probe_record["query"] = name
                    mesh_runner.locate_sorted = probe_rec
                try:
                    runner(name, where).execute(sql)
                finally:
                    gs._launch = gs_orig
                    mesh_runner.locate_sorted = probe_kernel
                log(f"arrays {name}_{where} capture: "
                    f"array_widths={dict(sorted(widths.items()))} "
                    f"gather_bytes={sum(gathered)} gather_batches={len(gathered)}")
    finally:
        ExprCompiler.value = value_orig
        StageExecutor._remote_as_host = remote_orig
    log(f"{ARRAY_K2_QUERY}_mesh sorted-probe launches (P, cap_b, n_match, S): "
        f"{probe_record.get('shapes', {}).get(ARRAY_K2_QUERY, [])}")
    if "largest" in k1_capture:
        gids, mask, values, g = k1_capture["largest"]
        log(f"{ARRAY_K1_QUERY}_local largest grouped-sums launch: N={gids.shape[0]} "
            f"G={g} K={values.shape[1]}")

    # the local U3 under a budget: above its footprint (the raw-input
    # path's host copies start but are never waited for) and a quarter of
    # it (raw-input waves, spilled to disk)
    spill_dir = tempfile.mkdtemp(prefix="chip_smoke_spill_")
    config.install_config(config.load_cluster_config({"memory.spill-dir": spill_dir}))
    sql = ARRAY_QUERIES["U3"]
    try:
        r = memory_runner("tpch", False)
        order = result_order(r.create_plan(sql))
        plain = memory_run("U3_local", r, sql, "unbudgeted", spill_dir, False, (), False)
        footprint = r.last_query.peak_memory
        if footprint <= 0:
            raise AssertionError(f"U3_local: reserved peak {footprint}")
        for label, budget, budgeted in (("budget above footprint", 4 * footprint, False),
                                        ("budgeted", max(footprint // 4, 1), True)):
            memory_run("U3_local", memory_runner("tpch", False, query_max_memory=budget),
                       sql, f"{label} ({budget} B of footprint {footprint} B)", spill_dir,
                       budgeted, ("aggregation",), False,
                       expect=plain["res"].rows, order=order)
    finally:
        config.reset_config()
        shutil.rmtree(spill_dir, ignore_errors=True)

    totals = local.execute(ARRAY_U4_TOTALS).rows
    cpu = reference("5g")
    for name in ARRAY_QUERIES:
        names, types, rows, cpu_s, order = cpu[name]
        if not rows:
            raise AssertionError(f"{name}: the CPU reference returned no rows")
        for where in ("local", "mesh"):
            res, cold, warm = results[name, where]
            if res.column_names != names or [t.name for t in res.types] != types:
                raise AssertionError(f"{name} {where}: columns differ from the CPU run")
            kernel_f32 = name == ARRAY_K1_QUERY and where == "local"
            assert_rows_match(res.rows, rows, order,
                              float_rtol=KERNEL_RTOL if kernel_f32 else DOUBLE_RTOL)
            log(f"arrays {name}_{where}: cold_s={cold!r} warm_s={warm!r} "
                f"matches the CPU run ({len(rows)} rows, cpu wall_s={cpu_s!r})")
        log(f"arrays {name}: first row {rows[0]}")
    if plain["res"].rows != cpu["U3"][2]:
        raise AssertionError("U3_local under the budget runs: its rows differ from the CPU run")
    if totals != cpu["U4_totals"][2] or results["U4", "local"][0].rows != totals:
        raise AssertionError(f"U4 {results['U4', 'local'][0].rows} != lineitem totals {totals}")
    log(f"arrays U4: the round trip equals sum(l_quantity), count(*) = {totals[0]}")
    return {"k1_launches": k1_launches, "k2_launches": k2_launches}


# -- phase 5h: the streaming aggregates and the range-positional path ------------


def aggregates_cpu_reference(out_path: str) -> None:
    """The reference process's phase 5h part: the port's CPU run of every
    AGGREGATE_QUERIES query and of AGGREGATE_EXACT at tpch.sf1, pickled to
    `out_path` + ".aggregates" as {name: (column names, type names, rows,
    seconds, the ORDER BY and LIMIT)}."""
    import pickle

    from trino_tpu_torch.runtime.runner import LocalQueryRunner
    from trino_tpu_torch.testing import result_order

    cpu = LocalQueryRunner(catalog="tpch", schema="sf1", device="cpu")
    out = {}
    for name, sql in list(AGGREGATE_QUERIES.items()) + [("exact", AGGREGATE_EXACT)]:
        order = result_order(cpu.create_plan(sql))
        t0 = time.perf_counter()
        res = cpu.execute(sql)
        out[name] = (res.column_names, [t.name for t in res.types], res.rows,
                     time.perf_counter() - t0, order)
    with open(out_path + ".aggregates.part", "wb") as f:
        pickle.dump(out, f)
    os.replace(out_path + ".aggregates.part", out_path + ".aggregates")


def run_aggregate_path(reference) -> dict:
    """Phase 5h: AGGREGATE_QUERIES through the local runner and the
    4-worker mesh on the card, cold and warm, with wall time, peak device
    memory, the kernels' launches and the group path each grouped
    reduction took (`ops.aggregation.GROUP_PATHS`).  The mesh A3 must
    launch the sorted-probe kernel; the local A4 groups must take the
    positional path and no sorted reduction.  After the path's counts are
    read, one untimed capture run of the mesh A3 logs each sorted-probe
    launch's (P, cap_b, n_match, S).  Every result is held to the
    reference process's CPU run; the mesh A1 must equal the local A1
    exactly, and A1's estimates must lie within 4% of the exact distinct
    counts (l_partkey's is 200,000 at sf1)."""
    import trino_tpu_torch.parallel.runner as mesh_runner
    from trino_tpu_torch.ops import aggregation as agg
    from trino_tpu_torch.ops import grouped_sums as gs
    from trino_tpu_torch.ops import locate_sorted as ls
    from trino_tpu_torch.parallel.runner import DistributedQueryRunner
    from trino_tpu_torch.runtime.runner import LocalQueryRunner
    from trino_tpu_torch.testing import assert_rows_match

    local = LocalQueryRunner(catalog="tpch", schema="sf1")
    mesh = DistributedQueryRunner(catalog="tpch", schema="sf1", n_workers=MESH_WORKERS)
    results = {}
    gs.grouped_sums.launches = 0  # every kernel count, just before the path
    ls.locate_sorted.launches = 0
    for name, sql in AGGREGATE_QUERIES.items():
        for where in ("local", "mesh"):
            r = mesh if where == "mesh" else local
            walls = []
            for attempt in ("cold", "warm"):
                agg.GROUP_PATHS.clear()
                k1, k2 = gs.grouped_sums.launches, ls.locate_sorted.launches
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                res = r.execute(sql)  # rows come back to the host
                wall = time.perf_counter() - t0
                walls.append(wall)
                k1 = gs.grouped_sums.launches - k1
                k2 = ls.locate_sorted.launches - k2
                paths = dict(agg.GROUP_PATHS)
                if name == AGGREGATE_K2_QUERY and where == "mesh" and k2 == 0:
                    raise AssertionError(f"{name} mesh {attempt}: no locate_sorted launch")
                if name.startswith("A4") and where == "local" and (
                    not paths.get("positional") or paths.get("sorted")
                ):
                    raise AssertionError(f"{name} local {attempt}: group paths {paths}")
                log(
                    f"aggregates {name}_{where} {attempt}: wall_s={wall!r} "
                    f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
                    f"group_paths={paths} "
                    f"grouped_sums_launches={k1} locate_sorted_launches={k2} "
                    f"rows={len(res.rows)}"
                    + ("" if where == "local"
                       else f" mesh_events={r.last_stage_executor.counters}")
                )
            results[name, where] = (res, walls[0], walls[1])
    profile_warm("A1_local", local, AGGREGATE_QUERIES["A1"])
    profile_warm("A4_orderkey_local", local, AGGREGATE_QUERIES["A4_orderkey"])
    k1_launches = gs.grouped_sums.launches  # read just after the path
    k2_launches = ls.locate_sorted.launches
    log(f"aggregate path: grouped_sums launches={k1_launches} "
        f"locate_sorted launches={k2_launches}")

    # untimed, after the counts were read: the mesh A3's sorted-probe
    # launch shapes
    record: dict = {"query": AGGREGATE_K2_QUERY}
    probe_kernel, probe_rec = shape_recording_probe(record)
    mesh_runner.locate_sorted = probe_rec
    try:
        mesh.execute(AGGREGATE_QUERIES[AGGREGATE_K2_QUERY])
    finally:
        mesh_runner.locate_sorted = probe_kernel
    log(f"{AGGREGATE_K2_QUERY}_mesh sorted-probe launches (P, cap_b, n_match, S): "
        f"{record.get('shapes', {}).get(AGGREGATE_K2_QUERY, [])}")

    cpu = reference("5h")
    for name in AGGREGATE_QUERIES:
        names, types, rows, cpu_s, order = cpu[name]
        if not rows:
            raise AssertionError(f"{name}: the CPU reference returned no rows")
        for where in ("local", "mesh"):
            res, cold, warm = results[name, where]
            if res.column_names != names or [t.name for t in res.types] != types:
                raise AssertionError(f"{name} {where}: columns differ from the CPU run")
            assert_rows_match(res.rows, rows, order, float_rtol=DOUBLE_RTOL)
            log(f"aggregates {name}_{where}: cold_s={cold!r} warm_s={warm!r} "
                f"matches the CPU run ({len(rows)} rows, cpu wall_s={cpu_s!r})")
        log(f"aggregates {name}: first row {rows[0]}")
    a1_local, a1_mesh = results["A1", "local"][0].rows, results["A1", "mesh"][0].rows
    if a1_mesh != a1_local or a1_local != cpu["A1"][2]:
        raise AssertionError(f"A1: mesh {a1_mesh} / local {a1_local} / cpu {cpu['A1'][2]}")
    exact_orderkeys, exact_partkeys = cpu["exact"][2][0]
    est_orderkeys, est_partkeys = a1_local[0][0], a1_local[0][1]
    for label, est, exact in (("l_orderkey", est_orderkeys, exact_orderkeys),
                              ("l_partkey", est_partkeys, exact_partkeys),
                              ("l_partkey vs 200000", est_partkeys, 200_000)):
        if abs(est - exact) > 0.04 * exact:
            raise AssertionError(f"A1 approx_distinct({label}): {est} vs {exact}")
        log(f"aggregates A1 approx_distinct({label}): {est} vs exact {exact} "
            f"(relative error {(est - exact) / exact!r})")
    return {"k1_launches": k1_launches, "k2_launches": k2_launches}


# -- phase 5i: the holistic aggregates, TABLESAMPLE and MATCH_RECOGNIZE ----------


def holistic_witness_sql(name: str, sql: str, rows: list) -> str:
    """A HOLISTIC_TIES witness query with "{groups}" filled from `rows`
    (the result's group keys; H2's customer keys)."""
    group_cols = HOLISTIC_TIES[name][0]
    groups = sorted({r[c] for r in rows for c in group_cols})
    return sql.format(groups=", ".join(str(g) for g in groups))


def holistic_cpu_reference(out_path: str) -> None:
    """The reference process's phase 5i part: the port's CPU run of every
    HOLISTIC_QUERIES query, of HOLISTIC_EXACT and of every HOLISTIC_TIES
    witness query at tpch.sf1, pickled to `out_path` + ".holistic" as
    {name: (column names, type names, rows, seconds, the ORDER BY and
    LIMIT)}, the exact percentiles under "exact" and the witness rows
    under ("ties", query, column)."""
    import pickle

    from trino_tpu_torch.runtime.runner import LocalQueryRunner
    from trino_tpu_torch.testing import result_order

    t_part = time.perf_counter()
    cpu = LocalQueryRunner(catalog="tpch", schema="sf1", device="cpu")
    out = {}
    for name, sql in list(HOLISTIC_QUERIES.items()) + [("exact", HOLISTIC_EXACT)]:
        order = result_order(cpu.create_plan(sql))
        t0 = time.perf_counter()
        res = cpu.execute(sql)
        out[name] = (res.column_names, [t.name for t in res.types], res.rows,
                     time.perf_counter() - t0, order)
    for name, (_, columns) in HOLISTIC_TIES.items():
        for col, _, _, sql in columns:
            out["ties", name, col] = cpu.execute(
                holistic_witness_sql(name, sql, out[name][2])
            ).rows
    log(f"holistic cpu reference (5i): {time.perf_counter() - t_part:.1f} s of CPU work")
    with open(out_path + ".holistic.part", "wb") as f:
        pickle.dump(out, f)
    os.replace(out_path + ".holistic.part", out_path + ".holistic")


def tie_admissible(value, kind: str, n, pairs: list) -> bool:
    """Whether `value` is a right min_by/max_by result for one group whose
    witness rows are `pairs` [(key, value)]: the value of a row at the
    extreme key, or (the n form) an array whose j-th element is the value
    of a row at the j-th extreme key.  NULL keys are skipped, and in the n
    form NULL values too."""
    pairs = [(k, v) for k, v in pairs if k is not None and (n is None or v is not None)]
    keys = sorted((k for k, _ in pairs), reverse=kind == "max")
    if n is None:
        return value is None if not keys else value in {v for k, v in pairs if k == keys[0]}
    m = min(n, len(keys))
    return isinstance(value, list) and len(value) == m and all(
        value[j] in {v for k, v in pairs if k == keys[j]} for j in range(m)
    )


def mask_ties(name: str, rows: list, witness: dict) -> list:
    """`rows` with every HOLISTIC_TIES column checked against its witness
    rows and replaced by a marker (raises on a value no tied row holds)."""
    if name not in HOLISTIC_TIES:
        return rows
    group_cols, columns = HOLISTIC_TIES[name]
    out = [list(r) for r in rows]
    for col, kind, n, _ in columns:
        by_group: dict = {}
        for w in witness["ties", name, col]:
            by_group.setdefault(tuple(w[: len(group_cols)]), []).append(tuple(w[len(group_cols):]))
        for r in out:
            g = tuple(r[c] for c in group_cols)
            if not tie_admissible(r[col], kind, n, by_group.get(g, [])):
                raise AssertionError(
                    f"{name} column {col} group {g}: {r[col]!r} is no {kind}_by value "
                    f"of the tied rows {by_group.get(g, [])[:8]}"
                )
            r[col] = "<tie-checked>"
    return [tuple(r) for r in out]


def run_holistic_path(reference, capture: dict) -> dict:
    """Phase 5i: HOLISTIC_QUERIES through the local runner and the 4-worker
    mesh on the card (S1 local only: its mesh run must raise
    NotImplementedError naming SampleNode, as the JAX mesh does), cold and
    warm, with wall time, peak device memory, the kernels' launches, the
    group path of each grouped reduction (`ops.aggregation.GROUP_PATHS`),
    the mesh's aggregation events and, for M1, the device and host seconds
    of the pattern operator (`ops.pattern.PATTERN_LOG`: the sort and the
    DEFINE masks apart from the host walk and the measures).  The local H2
    must take only the sorted group path and the mesh H2 the single-stage
    repartition with no partial states; the mesh H3 must launch the
    sorted-probe kernel.  After the path's counts are read: one profiled
    warm run each of the local H2 and the mesh H3, and one untimed capture
    run of the mesh H3 that logs each sorted-probe launch's (P, cap_b,
    n_match, S) and keeps the largest launch's inputs in `capture` (held
    in phase 6).  Every result is held to the reference process's CPU run
    (min_by/max_by values to the tied rows, `mask_ties`); the mesh H1
    equals the local H1; H1's estimates lie within 1/32 relative of the
    exact percentiles; S1's total is within 1% of 600,122."""
    import trino_tpu_torch.parallel.runner as mesh_runner
    from trino_tpu_torch.ops import aggregation as agg
    from trino_tpu_torch.ops import grouped_sums as gs
    from trino_tpu_torch.ops import locate_sorted as ls
    from trino_tpu_torch.ops import pattern
    from trino_tpu_torch.parallel.runner import DistributedQueryRunner
    from trino_tpu_torch.runtime.runner import LocalQueryRunner
    from trino_tpu_torch.testing import assert_rows_match

    local = LocalQueryRunner(catalog="tpch", schema="sf1")
    mesh = DistributedQueryRunner(catalog="tpch", schema="sf1", n_workers=MESH_WORKERS)
    results = {}
    gs.grouped_sums.launches = 0  # every kernel count, just before the path
    ls.locate_sorted.launches = 0
    for name, sql in HOLISTIC_QUERIES.items():
        for where in ("local", "mesh"):
            r = mesh if where == "mesh" else local
            if where == "mesh" and name in HOLISTIC_LOCAL_ONLY:
                node = HOLISTIC_LOCAL_ONLY[name]
                try:
                    r.execute(sql)
                except NotImplementedError as e:
                    if node not in str(e):
                        raise
                    log(f"holistic {name}_mesh raises NotImplementedError as the JAX mesh does: {e}")
                else:
                    raise AssertionError(f"{name} mesh: ran, but the mesh has no {node}")
                continue
            walls = []
            for attempt in ("cold", "warm"):
                agg.GROUP_PATHS.clear()
                pattern.PATTERN_LOG.clear()
                k1, k2 = gs.grouped_sums.launches, ls.locate_sorted.launches
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                res = r.execute(sql)  # rows come back to the host
                wall = time.perf_counter() - t0
                walls.append(wall)
                k1 = gs.grouped_sums.launches - k1
                k2 = ls.locate_sorted.launches - k2
                paths = dict(agg.GROUP_PATHS)
                events = {} if where == "local" else dict(r.last_stage_executor.counters)
                if name == HOLISTIC_K2_QUERY and where == "mesh" and k2 == 0:
                    raise AssertionError(f"{name} mesh {attempt}: no locate_sorted launch")
                if name == "H2" and where == "local" and set(paths) != {"sorted"}:
                    raise AssertionError(f"H2 local {attempt}: group paths {paths}")
                if name == "H2" and where == "mesh" and (
                    not events.get("agg_single_stage") or events.get("agg_partial_states")
                ):
                    raise AssertionError(f"H2 mesh {attempt}: aggregation events {events}")
                walk = ""
                if pattern.PATTERN_LOG:
                    rows_in, parts, matches, dev_s, walk_s, out_s = pattern.PATTERN_LOG[-1]
                    walk = (f" pattern_rows={rows_in} partitions={parts} matches={matches} "
                            f"pattern_device_s={dev_s!r} pattern_walk_host_s={walk_s!r} "
                            f"pattern_output_host_s={out_s!r}")
                log(
                    f"holistic {name}_{where} {attempt}: wall_s={wall!r} "
                    f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
                    f"group_paths={paths} "
                    f"grouped_sums_launches={k1} locate_sorted_launches={k2} "
                    f"rows={len(res.rows)}{walk}"
                    + ("" if where == "local" else f" mesh_events={events}")
                )
            results[name, where] = (res, walls[0], walls[1])
    profile_warm("H2_local", local, HOLISTIC_QUERIES["H2"])
    profile_warm("H3_mesh", mesh, HOLISTIC_QUERIES["H3"])
    k1_launches = gs.grouped_sums.launches  # read just after the path
    k2_launches = ls.locate_sorted.launches
    log(f"holistic path: grouped_sums launches={k1_launches} "
        f"locate_sorted launches={k2_launches}")

    # untimed, after the counts were read: the mesh H3's sorted-probe launch
    # shapes, and the largest launch's inputs for phase 6
    capture["query"] = HOLISTIC_K2_QUERY
    probe_kernel, probe_rec = shape_recording_probe(capture)
    mesh_runner.locate_sorted = probe_rec
    try:
        mesh.execute(HOLISTIC_QUERIES[HOLISTIC_K2_QUERY])
    finally:
        mesh_runner.locate_sorted = probe_kernel
    log(f"{HOLISTIC_K2_QUERY}_mesh sorted-probe launches (P, cap_b, n_match, S): "
        f"{capture.get('shapes', {}).get(HOLISTIC_K2_QUERY, [])}")

    cpu = reference("5i")
    for name in HOLISTIC_QUERIES:
        names, types, rows, cpu_s, order = cpu[name]
        if not rows:
            raise AssertionError(f"{name}: the CPU reference returned no rows")
        expected = mask_ties(name, rows, cpu)
        for where in ("local", "mesh"):
            if (name, where) not in results:
                continue
            res, cold, warm = results[name, where]
            if res.column_names != names or [t.name for t in res.types] != types:
                raise AssertionError(f"{name} {where}: columns differ from the CPU run")
            assert_rows_match(mask_ties(name, res.rows, cpu), expected, order,
                              float_rtol=DOUBLE_RTOL)
            log(f"holistic {name}_{where}: cold_s={cold!r} warm_s={warm!r} "
                f"matches the CPU run ({len(rows)} rows, cpu wall_s={cpu_s!r})")
        log(f"holistic {name}: first row {rows[0]}")
    h1_local = mask_ties("H1", results["H1", "local"][0].rows, cpu)
    h1_mesh = mask_ties("H1", results["H1", "mesh"][0].rows, cpu)
    if h1_mesh != h1_local:
        raise AssertionError(f"H1: mesh {h1_mesh} / local {h1_local}")
    exact = cpu["exact"][2][0][1:]
    for i, (est, want) in enumerate(zip(results["H1", "local"][0].rows[0][:3], exact)):
        rel = abs(float(est) - float(want)) / abs(float(want))
        if rel > 1 / 32:
            raise AssertionError(f"H1 approx_percentile #{i}: {est} vs exact {want}")
        log(f"holistic H1 approx_percentile #{i}: {est} vs exact {want} "
            f"(relative error {rel!r})")
    sampled = sum(r[2] for r in results["S1", "local"][0].rows)
    if abs(sampled - HOLISTIC_SAMPLE_ROWS) > 0.01 * HOLISTIC_SAMPLE_ROWS:
        raise AssertionError(f"S1 sampled {sampled} rows, not ~{HOLISTIC_SAMPLE_ROWS}")
    log(f"holistic S1: {sampled} rows sampled of 6,001,215 "
        f"({(sampled - HOLISTIC_SAMPLE_ROWS) / HOLISTIC_SAMPLE_ROWS!r} off 10%)")
    return {"k1_launches": k1_launches, "k2_launches": k2_launches}


# -- phase 5j: the temporal types and the scalar-function breadth ----------------


def temporal_cpu_reference(out_path: str) -> None:
    """The reference process's phase 5j part: the port's CPU run of every
    TEMPORAL_QUERIES query at tpch.sf1, pickled to `out_path` + ".temporal"
    as {name: (column names, type names, rows, seconds, the ORDER BY and
    LIMIT)}."""
    import pickle

    from trino_tpu_torch.runtime.runner import LocalQueryRunner
    from trino_tpu_torch.testing import result_order

    t_part = time.perf_counter()
    cpu = LocalQueryRunner(catalog="tpch", schema="sf1", device="cpu")
    out = {}
    for name, sql in TEMPORAL_QUERIES.items():
        order = result_order(cpu.create_plan(sql))
        t0 = time.perf_counter()
        res = cpu.execute(sql)
        out[name] = (res.column_names, [t.name for t in res.types], res.rows,
                     time.perf_counter() - t0, order)
    log(f"temporal cpu reference (5j): {time.perf_counter() - t_part:.1f} s of CPU work")
    with open(out_path + ".temporal.part", "wb") as f:
        pickle.dump(out, f)
    os.replace(out_path + ".temporal.part", out_path + ".temporal")


def run_temporal_path(reference, k1_capture: dict, probe_record: dict) -> dict:
    """Phase 5j: TEMPORAL_QUERIES through the local runner and the 4-worker
    mesh on the card, cold and warm, with wall time, peak device memory,
    the kernels' launches, the group path of each grouped reduction, the
    host tables built over a dictionary (`expr.functions.HOST_TABLE_LOG`:
    function, dictionary entries, seconds; a table is kept across batches
    and queries, so a warm run finds it built) and the per-row host renders
    (`expr.functions.ROW_RENDER_LOG`: function, rows, seconds).  The local
    T1 (with `pallas_agg` on) must launch the grouped-sums kernel on every
    run and the mesh T2 the sorted-probe kernel.  After the path's counts
    are read: one profiled warm run each of the local T1 and the mesh T2,
    and one untimed capture run of each that keeps the largest launch's
    inputs (the local T1's grouped sums in `k1_capture`, held in phase 6a;
    the mesh T2's sorted probe in `probe_record`, held in phase 6).  Every
    result is held to the reference process's CPU run: doubles to relative
    1e-9, except the local T1's f32 kernel sums (KERNEL_RTOL, as phases 4
    and 5g); everything else exact, tz values in their offsets too."""
    import trino_tpu_torch.parallel.runner as mesh_runner
    from trino_tpu_torch.expr import functions as fns
    from trino_tpu_torch.ops import aggregation as agg
    from trino_tpu_torch.ops import grouped_sums as gs
    from trino_tpu_torch.ops import locate_sorted as ls
    from trino_tpu_torch.parallel.runner import DistributedQueryRunner
    from trino_tpu_torch.runtime.runner import LocalQueryRunner
    from trino_tpu_torch.testing import assert_rows_match

    local = LocalQueryRunner(catalog="tpch", schema="sf1")
    kernel_local = LocalQueryRunner(catalog="tpch", schema="sf1")
    kernel_local.execute("set session pallas_agg = true")
    mesh = DistributedQueryRunner(catalog="tpch", schema="sf1", n_workers=MESH_WORKERS)

    def runner(name, where):
        return mesh if where == "mesh" else kernel_local if name == TEMPORAL_K1_QUERY else local

    results = {}
    gs.grouped_sums.launches = 0  # every kernel count, just before the path
    ls.locate_sorted.launches = 0
    for name, sql in TEMPORAL_QUERIES.items():
        for where in ("local", "mesh"):
            r = runner(name, where)
            walls = []
            for attempt in ("cold", "warm"):
                agg.GROUP_PATHS.clear()
                fns.HOST_TABLE_LOG.clear()
                fns.ROW_RENDER_LOG.clear()
                k1, k2 = gs.grouped_sums.launches, ls.locate_sorted.launches
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                res = r.execute(sql)  # rows come back to the host
                wall = time.perf_counter() - t0
                walls.append(wall)
                k1 = gs.grouped_sums.launches - k1
                k2 = ls.locate_sorted.launches - k2
                if name == TEMPORAL_K1_QUERY and where == "local" and k1 == 0:
                    raise AssertionError(f"{name} local {attempt}: no grouped_sums launch")
                if name == TEMPORAL_K2_QUERY and where == "mesh" and k2 == 0:
                    raise AssertionError(f"{name} mesh {attempt}: no locate_sorted launch")
                tables = [(f, n, round(t, 6)) for f, n, t in fns.HOST_TABLE_LOG]
                renders = [(f, n, round(t, 6)) for f, n, t in fns.ROW_RENDER_LOG]
                log(
                    f"temporal {name}_{where} {attempt}: wall_s={wall!r} "
                    f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
                    f"group_paths={dict(agg.GROUP_PATHS)} "
                    f"grouped_sums_launches={k1} locate_sorted_launches={k2} "
                    f"host_tables(function, entries, s)={tables} "
                    f"host_table_s={sum(t for _, _, t in fns.HOST_TABLE_LOG)!r} "
                    f"row_renders(function, rows, s)={renders} "
                    f"row_render_s={sum(t for _, _, t in fns.ROW_RENDER_LOG)!r} "
                    f"rows={len(res.rows)}"
                    + ("" if where == "local" else f" mesh_events={r.last_stage_executor.counters}")
                )
            results[name, where] = (res, walls[0], walls[1])
    profile_warm("T1_local", kernel_local, TEMPORAL_QUERIES["T1"])
    profile_warm("T2_mesh", mesh, TEMPORAL_QUERIES["T2"])
    k1_launches = gs.grouped_sums.launches  # read just after the path
    k2_launches = ls.locate_sorted.launches
    log(f"temporal path: grouped_sums launches={k1_launches} "
        f"locate_sorted launches={k2_launches}")

    # untimed, after the counts were read: the kernels' largest inputs
    gs_orig, gs_rec = grouped_sums_recorder(k1_capture)
    probe_kernel, probe_rec = shape_recording_probe(probe_record)
    k1_capture["query"] = TEMPORAL_K1_QUERY
    probe_record["query"] = TEMPORAL_K2_QUERY
    gs._launch = gs_rec
    try:
        kernel_local.execute(TEMPORAL_QUERIES[TEMPORAL_K1_QUERY])
    finally:
        gs._launch = gs_orig
    mesh_runner.locate_sorted = probe_rec
    try:
        mesh.execute(TEMPORAL_QUERIES[TEMPORAL_K2_QUERY])
    finally:
        mesh_runner.locate_sorted = probe_kernel
    log(f"{TEMPORAL_K2_QUERY}_mesh sorted-probe launches (P, cap_b, n_match, S): "
        f"{probe_record.get('shapes', {}).get(TEMPORAL_K2_QUERY, [])}")
    if "largest" in k1_capture:
        gids, _, values, g = k1_capture["largest"]
        log(f"{TEMPORAL_K1_QUERY}_local largest grouped-sums launch: N={gids.shape[0]} "
            f"G={g} K={values.shape[1]}")

    cpu = reference("5j")
    for name in TEMPORAL_QUERIES:
        names, types, rows, cpu_s, order = cpu[name]
        if not rows:
            raise AssertionError(f"{name}: the CPU reference returned no rows")
        for where in ("local", "mesh"):
            res, cold, warm = results[name, where]
            if res.column_names != names or [t.name for t in res.types] != types:
                raise AssertionError(f"{name} {where}: columns differ from the CPU run")
            kernel_f32 = name == TEMPORAL_K1_QUERY and where == "local"
            assert_rows_match(res.rows, rows, order,
                              float_rtol=KERNEL_RTOL if kernel_f32 else DOUBLE_RTOL)
            log(f"temporal {name}_{where}: cold_s={cold!r} warm_s={warm!r} "
                f"matches the CPU run ({len(rows)} rows, cpu wall_s={cpu_s!r})")
        log(f"temporal {name}: first row {rows[0]}")
    return {"k1_launches": k1_launches, "k2_launches": k2_launches}


# -- phase 5k: the statement layer over the memory and blackhole catalogs --------


def table_digest(stored) -> tuple:
    """An order-free digest of one stored memory table: its row count, each
    column's name, type, dtype and dictionary (a sha256 of its values), and
    a sha256 of the sorted per-row hashes over every column's raw value
    (a dictionary column's code, NULL as a sentinel): two stores hold the
    same rows, codes and dictionaries exactly when the digests agree."""
    import hashlib

    n = stored.rows
    h = np.full(n, 0x9E3779B97F4A7C15, dtype=np.uint64)
    cols = []
    with np.errstate(over="ignore"):
        for meta, cd in zip(stored.meta.columns, stored.columns):
            vals = np.ascontiguousarray(cd.values)
            planes = vals.reshape(n, -1) if vals.ndim > 1 else vals.reshape(n, 1)
            if planes.dtype.itemsize == 8:
                raw = planes.view(np.uint64)
            else:
                raw = planes.astype(np.int64).view(np.uint64)
            if cd.valid is not None:
                raw = np.where(np.asarray(cd.valid, bool)[:, None], raw, np.uint64(0xDEADBEEF))
            for j in range(raw.shape[1]):
                x = h ^ raw[:, j]
                x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
                x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
                h = x ^ (x >> np.uint64(31))
            dict_sha = None
            if cd.dictionary is not None:
                dict_sha = hashlib.sha256("\x00".join(cd.dictionary.values).encode()).hexdigest()
            cols.append((meta.name, meta.type.name, str(vals.dtype), dict_sha))
    rows_sha = hashlib.sha256(np.sort(h).tobytes()).hexdigest() if stored.columns else None
    return (n, tuple(cols), rows_sha)


def memory_digests(catalogs, memo: dict) -> dict:
    """{"catalog.schema.table": table_digest} of every memory table; a
    table whose column list is the one already digested (a write replaces
    the list) is not digested again."""
    from trino_tpu_torch.connectors.memory import MemoryConnector

    out = {}
    for name in catalogs.names():
        conn = catalogs.get(name)
        if not isinstance(conn, MemoryConnector):
            continue
        for (schema, table), st in sorted(conn.store.items()):
            key = f"{name}.{schema}.{table}"
            held = memo.get(key)
            if held is None or held[0] is not st.columns or held[1] != st.meta:
                held = (st.columns, st.meta, table_digest(st))
                memo[key] = held
            out[key] = held[2]
    return out


ANALYZE_LINE = re.compile(r"^(\s*)(\w+)\[[^\]]*\] rows=(\d+) batches=(\d+) wall=")


def analyze_lines(rows) -> list:
    """EXPLAIN ANALYZE's operator lines as (depth, name, rows, batches)."""
    out = []
    for (line,) in rows:
        m = ANALYZE_LINE.match(line)
        if m:
            out.append((len(m.group(1)) // 2, m.group(2), int(m.group(3)), int(m.group(4))))
    return out


def statement_order(runner, sql: str):
    """How a statement's rows compare: a query's ORDER BY and LIMIT, None
    for a multiset (EXECUTE's query), "exact" for every other statement."""
    from trino_tpu_torch.testing import result_order

    head = sql.lstrip().lower()
    if head.startswith(("select", "with")):
        return result_order(runner.create_plan(sql))
    if head.startswith("execute"):
        return None
    return "exact"


def statement_runners(catalogs, device=None) -> dict:
    """Phase 5k's two runners over one CatalogManager: "local" with
    `pallas_agg` on, "mesh" (the 4-worker mesh; on the CPU reference a
    second LocalQueryRunner) with `pallas_probe` on."""
    from trino_tpu_torch.parallel.runner import DistributedQueryRunner
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    local = LocalQueryRunner(catalogs, catalog="tpch", schema="sf1", device=device)
    if device == "cpu":
        mesh = LocalQueryRunner(catalogs, catalog="tpch", schema="sf1", device=device)
    else:
        mesh = DistributedQueryRunner(catalogs, catalog="tpch", schema="sf1",
                                      n_workers=MESH_WORKERS, device=device)
    local.execute("set session pallas_agg = true")
    mesh.execute("set session pallas_probe = true")
    return {"local": local, "mesh": mesh}


def statements_cpu_reference(out_path: str) -> None:
    """The reference process's phase 5k part: the port's CPU run of every
    phase 5k step (the mesh's steps on a second CPU LocalQueryRunner over
    the same catalogs), pickled to `out_path` + ".statements" as {label:
    ([(column names, type names, rows or EXPLAIN ANALYZE's operator lines,
    how rows compare) per statement], the memory tables' digests after the
    step, seconds)}; a `raises` step is the card's alone."""
    import pickle

    from trino_tpu_torch.connectors.api import default_catalogs

    t_part = time.perf_counter()
    catalogs = default_catalogs()
    runners = statement_runners(catalogs, device="cpu")
    memo: dict = {}
    out = {}
    for step in statement_steps("sf1"):
        if step.raises:
            continue
        r = runners[step.where]
        t0 = time.perf_counter()
        results = []
        for sql in step.statements:
            if step.fragments:
                from trino_tpu_torch.parallel.runner import DistributedQueryRunner

                cpu_mesh = DistributedQueryRunner(catalogs, catalog="tpch", schema="sf1",
                                                  n_workers=MESH_WORKERS, device="cpu")
                cpu_mesh.execute("set session pallas_probe = true")
                inner = sql[len("explain analyze "):]
                results.append((["Query Plan"], ["varchar"], fragment_kinds(cpu_mesh, inner),
                                "fragments"))
                continue
            order = statement_order(r, sql)
            res = r.execute(sql)
            rows = analyze_lines(res.rows) if step.analyze else res.rows
            results.append((res.column_names, [t.name for t in res.types], rows, order))
        out[step.label] = (results, memory_digests(catalogs, memo), time.perf_counter() - t0)
    log(f"statements cpu reference (5k): {time.perf_counter() - t_part:.1f} s of CPU work")
    with open(out_path + ".statements.part", "wb") as f:
        pickle.dump(out, f)
    os.replace(out_path + ".statements.part", out_path + ".statements")


def run_statement_path(reference, k1_capture: dict, probe_record: dict) -> dict:
    """Phase 5k: the statement layer on the card at sf1 (see STATEMENT
    steps): every step through its runner ("local": LocalQueryRunner with
    `pallas_agg` on; "mesh": the 4-worker DistributedQueryRunner with
    `pallas_probe` on; one CatalogManager), a read cold and warm, a write
    once, with wall time, peak device memory, the kernels' launches and,
    for every table write, the host seconds of its three parts
    (the runner's `last_writes`: `_collect_rows`, of which batches turned
    into rows; the column build; the sink's append).  D1's Q1 must launch
    the grouped-sums kernel on every run and D3's join the sorted-probe
    kernel; the mesh EXPLAIN ANALYZE's profile must have the CPU mesh's
    fragment ids and kinds.  Right
    after D1's Q1 and D3's join, one untimed capture run each keeps the
    largest launch's inputs (K1 in `k1_capture`, held in phase 6a; K2 in
    `probe_record`, held in phase 6); their launches are counted apart and
    left out of the path's.  Then every statement's result and the memory
    tables' digests after every step are held to the reference process's
    CPU run: the local runner's doubles (K1's f32 sums) to relative 5e-5,
    the mesh's to 1e-9, EXPLAIN text exactly, EXPLAIN ANALYZE on its
    operator names, rows= and batches=, the tables exactly."""
    import trino_tpu_torch.parallel.runner as mesh_runner
    from trino_tpu_torch.connectors.api import default_catalogs
    from trino_tpu_torch.ops import grouped_sums as gs
    from trino_tpu_torch.ops import locate_sorted as ls
    from trino_tpu_torch.testing import ResultOrder, assert_rows_match

    catalogs = default_catalogs()
    runners = statement_runners(catalogs)
    memo: dict = {}
    results = {}
    capture_launches = {"k1": 0, "k2": 0}
    all_writes = []
    gs.grouped_sums.launches = 0  # every kernel count, just before the path
    ls.locate_sorted.launches = 0
    for step in statement_steps("sf1"):
        r = runners[step.where]
        if step.raises:
            try:
                r.execute(step.statements[0])
            except NotImplementedError as e:
                if step.raises not in str(e):
                    raise
                log(f"statements {step.label}: raises NotImplementedError: {e}")
                continue
            raise AssertionError(f"{step.label}: did not raise naming {step.raises}")
        walls = []
        for attempt in ("cold", "warm") if step.repeat else ("once",):
            k1, k2 = gs.grouped_sums.launches, ls.locate_sorted.launches
            torch.cuda.reset_peak_memory_stats()
            outs, step_writes = [], []
            t0 = time.perf_counter()
            for sql in step.statements:
                outs.append(r.execute(sql))  # rows on the host
                step_writes += r.last_writes
            wall = time.perf_counter() - t0
            all_writes += step_writes
            walls.append(wall)
            k1 = gs.grouped_sums.launches - k1
            k2 = ls.locate_sorted.launches - k2
            if step.label == "D1_q1" and k1 == 0:
                raise AssertionError(f"D1_q1 {attempt}: no grouped_sums launch")
            if step.label == "D3_join" and k2 == 0:
                raise AssertionError(f"D3_join {attempt}: no locate_sorted launch")
            writes = [
                f"{kind} {table} rows={n} collect_s={c!r} to_rows_s={p!r} "
                f"build_s={b!r} append_s={a!r}"
                for kind, table, n, c, p, b, a in step_writes
            ]
            log(
                f"statements {step.label} {attempt}: wall_s={wall!r} "
                f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
                f"grouped_sums_launches={k1} locate_sorted_launches={k2} "
                f"rows={[len(o.rows) for o in outs]}"
                + (f" writes=[{'; '.join(writes)}]" if writes else "")
                + (f" mesh_events={r.last_stage_executor.counters}"
                   if step.where == "mesh" and r.last_stage_executor is not None else "")
            )
        if step.analyze or step.fragments:
            for (line,) in outs[0].rows:
                log(f"statements {step.label}: {line}")
        results[step.label] = (outs, walls, memory_digests(catalogs, memo))
        if step.label in ("D1_q1", "D3_join"):
            # untimed, launches counted apart: the kernel's largest inputs
            k1, k2 = gs.grouped_sums.launches, ls.locate_sorted.launches
            if step.label == "D1_q1":
                gs_orig, gs_rec = grouped_sums_recorder(k1_capture)
                k1_capture["query"] = step.label
                gs._launch = gs_rec
                try:
                    r.execute(step.statements[0])
                finally:
                    gs._launch = gs_orig
                gids, _, values, g = k1_capture["largest"]
                log(f"D1_q1 largest grouped-sums launch: N={gids.shape[0]} G={g} "
                    f"K={values.shape[1]}")
            else:
                probe_kernel, probe_rec = shape_recording_probe(probe_record)
                probe_record["query"] = step.label
                mesh_runner.locate_sorted = probe_rec
                try:
                    r.execute(step.statements[0])
                finally:
                    mesh_runner.locate_sorted = probe_kernel
                log(f"D3_join sorted-probe launches (P, cap_b, n_match, S): "
                    f"{probe_record.get('shapes', {}).get(step.label, [])}")
            capture_launches["k1"] += gs.grouped_sums.launches - k1
            capture_launches["k2"] += ls.locate_sorted.launches - k2
    k1_launches = gs.grouped_sums.launches - capture_launches["k1"]  # read just after
    k2_launches = ls.locate_sorted.launches - capture_launches["k2"]
    log(f"statement path: grouped_sums launches={k1_launches} "
        f"locate_sorted launches={k2_launches} (capture runs apart: {capture_launches})")
    for kind, table, n, c, p, b, a in all_writes:
        log(f"statements write {kind} {table}: rows={n} collect_s={c!r} to_rows_s={p!r} "
            f"build_s={b!r} append_s={a!r}")

    cpu = reference("5k")
    for step in statement_steps("sf1"):
        if step.raises:
            continue
        outs, walls, digests = results[step.label]
        expected, cpu_digests, cpu_s = cpu[step.label]
        rtol = KERNEL_RTOL if step.where == "local" else DOUBLE_RTOL
        for res, (names, types, rows, order) in zip(outs, expected):
            if res.column_names != names or [t.name for t in res.types] != types:
                raise AssertionError(f"{step.label}: columns differ from the CPU run")
            if step.analyze:
                if analyze_lines(res.rows) != rows:
                    raise AssertionError(f"{step.label}: operators differ from the CPU run:\n"
                                         f"{analyze_lines(res.rows)}\n{rows}")
                continue
            if step.fragments:
                if profile_fragment_lines(res.rows) != rows:
                    raise AssertionError(f"{step.label}: fragments differ from the CPU's:\n"
                                         f"{profile_fragment_lines(res.rows)}\n{rows}")
                continue
            if order == "exact":
                order = ResultOrder(tuple(range(len(rows[0]) if rows else 0)), None)
            elif order is None:
                order = ResultOrder((), None)
            assert_rows_match(res.rows, rows, order, float_rtol=rtol)
        if digests != cpu_digests:
            raise AssertionError(f"{step.label}: the memory tables differ from the CPU run:\n"
                                 f"{digests}\n{cpu_digests}")
        log(f"statements {step.label}: walls_s={walls!r} matches the CPU run "
            f"(tables {sorted(digests)}; cpu wall_s={cpu_s!r}); "
            f"first rows {[o.rows[:1] for o in outs]}")
    return {"k1_launches": k1_launches, "k2_launches": k2_launches}


# -- phase 5l: the query lifecycle, events, tracing, the mesh profile, the ------
# -- system catalog and the concurrent dispatcher -------------------------------

#: phase 5l's L3 statement: a CTAS of every order into memory (its warm wall
#: on the card is seconds, and `_collect_rows` pulls one batch per split)
LIFECYCLE_CTAS = (
    "create table memory.default.l3_orders as select "
    + ORDERS_COLUMNS + " from tpch.{s}.orders"
)
LIFECYCLE_CTAS_CHECK = "select count(*), sum(o_totalprice) from memory.default.l3_orders"
#: phase 5l's L4 statements on the dispatcher's lanes (tpch.sf1), each three
#: times, split between the resource groups
LIFECYCLE_DISPATCH = ("q1_double", "q6", "q3", "q18")
#: phase 5l's L5 statements through the etc/-built runner
LIFECYCLE_ETC = ("select count(*) from nation", "select count(*), sum(o_totalprice) from orders")
FRAGMENT_LINE = re.compile(r"^\s*Fragment (\d+) \[(.*)\] wall=")


def lifecycle_sql(name: str, schema: str = "sf1") -> str:
    from trino_tpu_torch.connectors.tpch.queries import QUERIES

    return {
        "q1_double": Q1_DOUBLE, "q3": QUERIES[3], "q6": QUERIES[6], "q18": QUERIES[18],
    }[name]


def fragment_kinds(mesh, sql: str) -> dict:
    """{fragment id: partitioning} of `sql` as `mesh` fragments it."""
    sub = mesh.create_subplan(mesh.create_plan(sql))
    return {f.id: str(f.partitioning) for f in sub.all_fragments()}


def profile_fragment_lines(rows) -> dict:
    """The mesh EXPLAIN ANALYZE's `Fragment <id> [<kind>] wall=...` lines as
    {id: kind}."""
    out = {}
    for (line,) in rows:
        m = FRAGMENT_LINE.match(line)
        if m:
            out[int(m.group(1))] = m.group(2)
    return out


def abort_outcome(runner, sql: str, cancel_at_start: bool = False, qids=None) -> tuple:
    """(state, error type, error code, exception class name) of one statement
    that must fail, from its completed event (its query id is appended to
    `qids`); `cancel_at_start` cancels it as soon as its QueryContext
    exists."""
    from trino_tpu_torch.runtime.events import CollectingEventListener

    listener = CollectingEventListener()
    runner.events.add(listener)
    if cancel_at_start:
        runner._query_context_cb = lambda ctx: ctx.cancel()
    try:
        runner.execute(sql)
    except Exception as e:  # noqa: BLE001 - the outcome is what is checked
        name = type(e).__name__
    else:
        raise AssertionError(f"{sql[:60]}: did not fail")
    finally:
        runner.events.listeners.remove(listener)
        runner._query_context_cb = None
    done = listener.completed[-1]
    if qids is not None:
        qids.append(done.query_id)
    return (done.state, done.error_type, done.error_code, name)


def lifecycle_cpu_reference(out_path: str) -> None:
    """The reference process's phase 5l part: the port's CPU run of phase
    5l's queries (Q1-double and its EXPLAIN ANALYZE VERBOSE operator lines,
    Q3, Q6, Q18, the L3 CTAS and its check, the L5 queries), the fragments
    of Q3 on a 4-worker mesh, and the lifecycle outcomes that do not depend
    on time (a planning deadline, a run deadline, a cancel), pickled to
    `out_path` + ".lifecycle"."""
    import pickle

    from trino_tpu_torch.parallel.runner import DistributedQueryRunner
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    t_part = time.perf_counter()
    r = LocalQueryRunner(catalog="tpch", schema="sf1", device="cpu")
    r.execute("set session pallas_agg = true")
    out = {name: r.execute(lifecycle_sql(name)).rows for name in LIFECYCLE_DISPATCH}
    out["q1_double_analyze"] = analyze_lines(
        r.execute("explain analyze verbose " + Q1_DOUBLE).rows
    )
    mesh = DistributedQueryRunner(catalog="tpch", schema="sf1", n_workers=MESH_WORKERS,
                                  device="cpu")
    mesh.execute("set session pallas_probe = true")
    out["q3_fragments"] = fragment_kinds(mesh, lifecycle_sql("q3"))
    ctas = LIFECYCLE_CTAS.format(s="sf1")
    r.execute("set session query_max_planning_time = 0.000001")
    out["abort_planning"] = abort_outcome(r, Q1_DOUBLE)
    r.execute("set session query_max_planning_time = 0")
    r.execute("set session query_max_run_time = 0.000001")
    out["abort_run"] = abort_outcome(r, ctas)
    r.execute("set session query_max_run_time = 0")
    out["abort_cancel"] = abort_outcome(r, ctas, cancel_at_start=True)
    out["ctas"] = r.execute(ctas).rows
    out["ctas_check"] = r.execute(LIFECYCLE_CTAS_CHECK).rows
    out["etc"] = [r.execute(sql).rows for sql in LIFECYCLE_ETC]
    log(f"lifecycle cpu reference (5l): {time.perf_counter() - t_part:.1f} s of CPU work")
    with open(out_path + ".lifecycle.part", "wb") as f:
        pickle.dump(out, f)
    os.replace(out_path + ".lifecycle.part", out_path + ".lifecycle")


def mesh_event_series() -> dict:
    from trino_tpu_torch.telemetry.metrics import mesh_events_counter

    return {lv[0]: v for _, lv, v in
            ((s[0], s[2], s[3]) for s in mesh_events_counter().series())}


def run_lifecycle_path(reference, k1_capture: dict, probe_record: dict) -> dict:
    """Phase 5l: the query lifecycle on the card at tpch.sf1 (see the module
    docstring, L1-L5).  The kernels' counts are set to 0 just before the
    path and read just after; untimed capture runs (K1 after L1, K2 after
    L2) are counted apart."""
    import shutil
    import threading

    import trino_tpu_torch.parallel.runner as mesh_runner
    from trino_tpu_torch import config
    from trino_tpu_torch.ops import grouped_sums as gs
    from trino_tpu_torch.ops import locate_sorted as ls
    from trino_tpu_torch.parallel.runner import DistributedQueryRunner
    from trino_tpu_torch.runtime.config import runner_from_etc
    from trino_tpu_torch.runtime.dispatcher import QueryDispatcher, QueryShedError
    from trino_tpu_torch.runtime.events import CollectingEventListener
    from trino_tpu_torch.runtime.lifecycle import memory_pool
    from trino_tpu_torch.runtime.query_stats import MESH_PHASES
    from trino_tpu_torch.runtime.resource_groups import (
        ResourceGroupConfig,
        ResourceGroupManager,
    )
    from trino_tpu_torch.runtime.runner import LocalQueryRunner
    from trino_tpu_torch.telemetry.metrics import REGISTRY, gate_wait_histogram

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "build", "chip_smoke_5l")
    shutil.rmtree(work, ignore_errors=True)
    spill_dir = os.path.join(work, "spill")
    os.makedirs(spill_dir)
    config.install_config(config.load_cluster_config({"memory.spill-dir": spill_dir}))
    local = LocalQueryRunner(catalog="tpch", schema="sf1")
    local.execute("set session pallas_agg = true")
    listener = CollectingEventListener()
    local.events.add(listener)
    mesh = DistributedQueryRunner(catalog="tpch", schema="sf1", n_workers=MESH_WORKERS)
    mesh.execute("set session pallas_probe = true")
    capture = {"k1": 0, "k2": 0}
    results: dict = {}
    gs.grouped_sums.launches = 0  # every kernel count, just before the path
    ls.locate_sorted.launches = 0

    # -- L1: the local runner, traced, with K1 ---------------------------------
    if not local.properties.get("query_trace"):
        raise AssertionError("query_trace must default on")
    for attempt in ("cold", "warm"):
        k1 = gs.grouped_sums.launches
        t0 = time.perf_counter()
        res = local.execute(Q1_DOUBLE)
        wall = time.perf_counter() - t0
        k1 = gs.grouped_sums.launches - k1
        if k1 == 0:
            raise AssertionError(f"L1 {attempt}: no grouped_sums launch")
        done = listener.completed[-1]
        qid, st = done.query_id, done.statistics
        spans = local.execute(
            "select span_id, parent_id, name from system.runtime.spans "
            f"where query_id = '{qid}'"
        ).rows
        roots = [s for s in spans if s[1] == 0]
        names = {s[2] for s in spans}
        if len(roots) != 1 or not {"query", "analyze", "optimize", "execute"} <= names:
            raise AssertionError(f"L1 {attempt}: spans {spans}")
        row = local.execute(
            f"select state, rows from system.runtime.queries where query_id = '{qid}'"
        ).rows
        if row != [("FINISHED", 4)]:
            raise AssertionError(f"L1 {attempt}: system.runtime.queries has {row}")
        if not (st.wall_s > 0 and st.rows == 4 and st.peak_memory_bytes > 0
                and st.spans == len(spans)):
            raise AssertionError(f"L1 {attempt}: statistics {st}")
        results[f"L1_{attempt}"] = res
        log(f"lifecycle L1 {attempt}: wall_s={wall!r} grouped_sums_launches={k1} "
            f"query_id={qid} spans={len(spans)} statistics={st}")
    res = local.execute("explain analyze verbose " + Q1_DOUBLE)
    text = [line for (line,) in res.rows]
    trace_lines = [line for line in text if line.startswith("Trace JSON: ")]
    if len(trace_lines) != 1 or not any(line.startswith("Query trace (spans") for line in text):
        raise AssertionError("L1: EXPLAIN ANALYZE VERBOSE lacks the span tree or the trace")
    chrome = json.loads(trace_lines[0][len("Trace JSON: "):])
    if chrome["traceEvents"][0]["name"] != "query":
        raise AssertionError("L1: the trace's first event is not the query span")
    results["L1_analyze"] = analyze_lines(res.rows)
    for line in text:
        if not line.startswith("Trace JSON: "):
            log(f"lifecycle L1 explain analyze verbose: {line}")
    log(f"lifecycle L1 trace: {len(chrome['traceEvents'])} events, "
        f"{len(trace_lines[0])} bytes of JSON")
    k1 = gs.grouped_sums.launches
    gs_orig, gs_rec = grouped_sums_recorder(k1_capture)
    k1_capture["query"] = "L1_q1_double"
    gs._launch = gs_rec
    try:
        local.execute(Q1_DOUBLE)  # untimed: the kernel's largest inputs
    finally:
        gs._launch = gs_orig
    capture["k1"] += gs.grouped_sums.launches - k1

    # -- L2: EXPLAIN ANALYZE of Q3 on the 4-worker mesh, with K2 -----------------
    q3 = lifecycle_sql("q3")
    series0 = mesh_event_series()
    k2 = ls.locate_sorted.launches
    t0 = time.perf_counter()
    res = mesh.execute("explain analyze " + q3)
    wall = time.perf_counter() - t0
    k2_analyze = ls.locate_sorted.launches - k2
    prof = mesh.last_mesh_profile
    if not prof.blocking:
        raise AssertionError("L2: the EXPLAIN ANALYZE profile is not blocking")
    series1 = mesh_event_series()
    delta = {k: series1[k] - series0.get(k, 0) for k in series1
             if series1[k] != series0.get(k, 0)}
    if delta != prof.counters:
        raise AssertionError(f"L2: registry deltas {delta} != profile counters {prof.counters}")
    for fid, st in prof.fragments.items():
        if abs(sum(st.phases.values()) - st.wall_s) > 1e-6:
            raise AssertionError(f"L2: fragment {fid} phases do not sum to its wall")
        if set(st.phases) != set(MESH_PHASES):
            raise AssertionError(f"L2: fragment {fid} phases {sorted(st.phases)}")
    results["L2_fragments"] = {fid: st.kind for fid, st in prof.fragments.items()}
    results["L2_lines"] = profile_fragment_lines(res.rows)
    if k2_analyze == 0:
        raise AssertionError("L2: EXPLAIN ANALYZE launched no locate_sorted")
    log(f"lifecycle L2 explain analyze: wall_s={wall!r} locate_sorted_launches={k2_analyze}")
    for (line,) in res.rows:
        log(f"lifecycle L2 explain analyze: {line}")
    log(f"lifecycle L2 last_mesh_profile: {json.dumps(prof.to_json())}")
    for attempt in ("cold", "warm"):
        k2 = ls.locate_sorted.launches
        t0 = time.perf_counter()
        results[f"L2_{attempt}"] = mesh.execute(q3)
        wall = time.perf_counter() - t0
        n = ls.locate_sorted.launches - k2
        if n == 0:
            raise AssertionError(f"L2 {attempt}: no locate_sorted launch")
        log(f"lifecycle L2 plain {attempt}: wall_s={wall!r} locate_sorted_launches={n} "
            f"phase_totals_s={mesh.last_mesh_profile.phase_totals()}")
    k2 = ls.locate_sorted.launches
    probe_kernel, probe_rec = shape_recording_probe(probe_record)
    probe_record["query"] = "L2_q3_mesh"
    mesh_runner.locate_sorted = probe_rec
    try:
        mesh.execute(q3)  # untimed: the kernel's largest inputs
    finally:
        mesh_runner.locate_sorted = probe_kernel
    capture["k2"] += ls.locate_sorted.launches - k2
    log(f"lifecycle L2 sorted-probe launches (P, cap_b, n_match, S): "
        f"{probe_record.get('shapes', {}).get('L2_q3_mesh', [])}")

    # -- L3: deadlines and cancel on the card ---------------------------------------
    aborts = {}

    def after_abort(label: str, qid: str) -> None:
        if memory_pool().root.reserved != 0:
            raise AssertionError(f"L3 {label}: the pool holds {memory_pool().root.reserved} bytes")
        left = os.listdir(spill_dir)
        if left:
            raise AssertionError(f"L3 {label}: spill files left {left}")
        row = local.execute(
            "select state, error_type, error_code from system.runtime.queries "
            f"where query_id = '{qid}'"
        ).rows
        if row != [aborts[label][:3]]:
            raise AssertionError(f"L3 {label}: system.runtime.queries has {row}")

    k1 = gs.grouped_sums.launches
    qids: list = []
    local.execute("set session query_max_planning_time = 0.000001")
    aborts["planning"] = abort_outcome(local, Q1_DOUBLE, qids=qids)
    # the deadline stays for later statements
    later = abort_outcome(local, lifecycle_sql("q6"))
    if later != aborts["planning"]:
        raise AssertionError(f"L3 planning: a later statement gave {later}")
    local.execute("set session query_max_planning_time = 0")
    if gs.grouped_sums.launches != k1:
        raise AssertionError("L3 planning: the deadline did not stop the query before the card")
    after_abort("planning", qids[-1])
    results["L3_after_planning"] = local.execute(Q1_DOUBLE)
    log(f"lifecycle L3 planning deadline: {aborts['planning']} (a later statement too); "
        "grouped_sums launches unchanged; the next run matches below")

    ctas = LIFECYCLE_CTAS.format(s="sf1")
    t0 = time.perf_counter()
    local.execute(ctas)
    warm = time.perf_counter() - t0
    local.execute("drop table memory.default.l3_orders")
    if warm < 1.0:
        raise AssertionError(f"L3: the CTAS's warm wall {warm!r} s is under 1 s")
    deadline = warm / 5
    local.execute(f"set session query_max_run_time = {deadline!r}")
    t0 = time.perf_counter()
    aborts["run"] = abort_outcome(local, ctas, qids=qids)
    aborted_at = time.perf_counter() - t0
    local.execute("set session query_max_run_time = 0")
    after_abort("run", qids[-1])
    local.execute("drop table if exists memory.default.l3_orders")
    results["L3_after_run"] = (local.execute(ctas).rows, local.execute(LIFECYCLE_CTAS_CHECK).rows)
    local.execute("drop table memory.default.l3_orders")
    log(f"lifecycle L3 run deadline: {aborts['run']} warm_wall_s={warm!r} "
        f"deadline_s={deadline!r} aborted_after_s={aborted_at!r} "
        f"past_deadline_s={aborted_at - deadline!r}")

    canceled = {}

    def canceller() -> None:
        while "qid" not in canceled:
            for ctx in local.query_tracker.live():
                if ctx.state == "RUNNING" and ctx.query_id.startswith("query_"):
                    time.sleep(0.2)  # well inside the statement's run
                    canceled["t"] = time.perf_counter()
                    canceled["ok"] = local.query_tracker.cancel(ctx.query_id)
                    canceled["qid"] = ctx.query_id
                    return
            time.sleep(0.001)

    th = threading.Thread(target=canceller, daemon=True)
    th.start()
    t0 = time.perf_counter()
    aborts["cancel"] = abort_outcome(local, ctas, qids=qids)
    t1 = time.perf_counter()
    th.join(timeout=30)
    if not canceled.get("ok") or canceled["qid"] != qids[-1]:
        raise AssertionError(f"L3 cancel: the second thread did not cancel it ({canceled})")
    after_abort("cancel", canceled["qid"])
    local.execute("drop table if exists memory.default.l3_orders")
    results["L3_after_cancel"] = (local.execute(ctas).rows, local.execute(LIFECYCLE_CTAS_CHECK).rows)
    local.execute("drop table memory.default.l3_orders")
    log(f"lifecycle L3 cancel: {aborts['cancel']} canceled_after_s={canceled['t'] - t0!r} "
        f"aborted_after_s={t1 - canceled['t']!r}")

    # -- L4: the dispatcher on the card, two lanes and two groups ------------------
    primary = LocalQueryRunner(catalog="tpch", schema="sf1")
    primary.execute("set session pallas_agg = true")
    d_listener = CollectingEventListener()
    primary.events.add(d_listener)
    serial = {}
    for name in LIFECYCLE_DISPATCH:
        primary.execute(lifecycle_sql(name))  # warm every statement first
        t0 = time.perf_counter()
        primary.execute(lifecycle_sql(name))
        serial[name] = time.perf_counter() - t0
    groups = ResourceGroupManager()
    groups.add(ResourceGroupConfig("etl", hard_concurrency=1, weight=1, max_queued=16))
    groups.add(ResourceGroupConfig("adhoc", hard_concurrency=2, weight=3, max_queued=16))
    groups.add(ResourceGroupConfig("flood", hard_concurrency=1, weight=1, max_queued=1))
    dispatcher = QueryDispatcher(primary, groups, lanes=2)
    primary.dispatcher = dispatcher
    if dispatcher.lanes != 2:
        raise AssertionError(f"L4: {dispatcher.lanes} lanes")
    jobs = [(("etl", "adhoc")[i % 2], LIFECYCLE_DISPATCH[i % 4]) for i in range(12)]
    done_jobs, errors = [], []
    lock = threading.Lock()
    n_events = len(d_listener.completed)
    gate0 = gate_wait_histogram().value()
    k1 = gs.grouped_sums.launches

    def client(k: int) -> None:
        for group, name in jobs[k::6]:
            try:
                t = dispatcher.enqueue(group_name=group)
                t.wait()
                res = dispatcher.run_admitted(t, lambda r, n=name: r.execute(lifecycle_sql(n)))
                with lock:
                    done_jobs.append((group, name, res))
            except BaseException as e:  # noqa: BLE001 - raised after the join
                with lock:
                    errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,)) for k in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    concurrent_wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    k1_dispatch = gs.grouped_sums.launches - k1  # read after every lane joined
    if len(done_jobs) != 12 or k1_dispatch == 0:
        raise AssertionError(f"L4: {len(done_jobs)} statements, {k1_dispatch} K1 launches")
    results["L4"] = done_jobs
    stats = {row[0]: row[1:] for row in primary.execute(
        "select name, total_admitted, running, queued from system.runtime.resource_groups"
    ).rows}
    if stats["etl"][0] + stats["adhoc"][0] != 12:
        raise AssertionError(f"L4: system.runtime.resource_groups {stats}")
    hold = dispatcher.enqueue(group_name="flood")
    hold.wait()
    queued = dispatcher.enqueue(group_name="flood")
    try:
        dispatcher.enqueue(group_name="flood")
    except QueryShedError as e:
        shed = str(e)
    else:
        raise AssertionError("L4: the flooded group did not shed")
    dispatcher.release(hold)
    queued.wait()
    dispatcher.release(queued)
    if not dispatcher.drain(wait_s=5.0, grace_s=0.0):
        raise AssertionError("L4: the dispatcher did not drain clean")
    h = gate_wait_histogram()
    counts, total, n = h._obs.get((), [[0] * len(h.buckets), 0.0, 0])
    log(f"lifecycle L4: 12 statements on 2 lanes wall_s={concurrent_wall!r} "
        f"serial_sum_s={3 * sum(serial.values())!r} serial_s={serial} "
        f"grouped_sums_launches={k1_dispatch} groups={stats} shed='{shed}'")
    log(f"lifecycle L4 gate wait: contended acquires={n - gate0} "
        f"histogram (le, count)={list(zip(h.buckets, counts))} sum_s={total!r}")
    for e in d_listener.completed[n_events:]:
        if not e.statistics.group:
            continue  # the resource-groups read
        log(f"lifecycle L4 {e.query_id}: group={e.statistics.group} "
            f"queued_s={e.statistics.queued_s!r} gate_wait_s={e.statistics.gate_wait_s!r} "
            f"wall_s={e.statistics.wall_s!r} rows={e.rows}")

    # -- L5: runner_from_etc and the system tables ---------------------------------
    etc = os.path.join(work, "etc")
    os.makedirs(os.path.join(etc, "catalog"))
    events_path = os.path.join(work, "events.jsonl")
    with open(os.path.join(etc, "config.properties"), "w") as f:
        f.write("default.catalog=tpch\ndefault.schema=sf1\n")
    with open(os.path.join(etc, "catalog", "tpch.properties"), "w") as f:
        f.write("connector.name=tpch\n")
    with open(os.path.join(etc, "catalog", "memory.properties"), "w") as f:
        f.write("connector.name=memory\n")
    with open(os.path.join(etc, "event-listener.properties"), "w") as f:
        f.write(f"event-listener.name=file\nfile.path={events_path}\n")
    r5 = runner_from_etc(etc)
    if r5.device.type != "cuda":
        raise AssertionError(f"L5: runner_from_etc resolved {r5.device}")
    # the registry's statement count before r5's first statement (read
    # directly: a statement would count itself)
    before = sum(row[3] for row in REGISTRY.rows() if row[0] == "trino_tpu_queries_total")
    ran = [0]

    def run5(sql):
        ran[0] += 1
        return r5.execute(sql)

    results["L5"] = [run5(sql).rows for sql in LIFECYCLE_ETC]
    with open(events_path) as f:
        events = [json.loads(line) for line in f]
    if [e["event"] for e in events] != ["query_created", "query_completed"] * 2:
        raise AssertionError(f"L5: events {events}")
    nodes = run5("select node_id, state from system.runtime.nodes").rows
    if nodes != [(f"cuda:{i}", "ACTIVE") for i in range(torch.cuda.device_count())]:
        raise AssertionError(f"L5: nodes {nodes}")
    caches = dict(run5("select tier, bytes from system.runtime.caches").rows)
    if not caches["device"] > 0:
        raise AssertionError(f"L5: caches {caches}")
    run5("set session agg_fold_batches = 3")
    value = run5(
        "select value from system.runtime.session_properties where name = 'agg_fold_batches'"
    ).rows
    # the read counts only once it has finished, so not in its own rows
    total = r5.execute(
        "select sum(value) from system.metrics.metrics where name = 'trino_tpu_queries_total'"
    ).rows[0][0]
    if value != [("3",)] or total - before != ran[0]:
        raise AssertionError(f"L5: session_properties {value}, queries_total {total} "
                             f"(before r5's statements {before}, r5 ran {ran[0]})")
    log(f"lifecycle L5: events={[(e['event'], e['query_id']) for e in events]} nodes={nodes} "
        f"caches={caches} agg_fold_batches={value} queries_total={total!r} "
        f"(before r5's statements {before!r}, r5 ran {ran[0]})")
    config.reset_config()
    shutil.rmtree(work, ignore_errors=True)
    k1_launches = gs.grouped_sums.launches - capture["k1"]  # read just after the path
    k2_launches = ls.locate_sorted.launches - capture["k2"]
    log(f"lifecycle path: grouped_sums launches={k1_launches} "
        f"locate_sorted launches={k2_launches} (capture runs apart: {capture})")

    cpu = reference("5l")
    rows_match(results["L1_cold"].rows, cpu["q1_double"], KERNEL_RTOL)
    rows_match(results["L1_warm"].rows, cpu["q1_double"], KERNEL_RTOL)
    rows_match(results["L3_after_planning"].rows, cpu["q1_double"], KERNEL_RTOL)
    if results["L1_analyze"] != cpu["q1_double_analyze"]:
        raise AssertionError(f"L1: operators {results['L1_analyze']} != "
                             f"{cpu['q1_double_analyze']}")
    for label in ("L2_fragments", "L2_lines"):
        if results[label] != cpu["q3_fragments"]:
            raise AssertionError(f"{label}: {results[label]} != {cpu['q3_fragments']}")
    rows_match(results["L2_cold"].rows, cpu["q3"], 0.0)
    rows_match(results["L2_warm"].rows, cpu["q3"], 0.0)
    for label in ("planning", "run", "cancel"):
        if aborts[label] != cpu[f"abort_{label}"]:
            raise AssertionError(f"L3 {label}: {aborts[label]} != {cpu[f'abort_{label}']}")
    for label in ("L3_after_run", "L3_after_cancel"):
        ctas_rows, check_rows = results[label]
        rows_match(ctas_rows, cpu["ctas"], 0.0)
        rows_match(check_rows, cpu["ctas_check"], 0.0)
    for group, name, res in results["L4"]:
        rows_match(res.rows, cpu[name], KERNEL_RTOL if name == "q1_double" else 0.0)
    for got, want in zip(results["L5"], cpu["etc"]):
        rows_match(got, want, 0.0)
    log("lifecycle path: L1-L5 match the CPU run (Q1-double's f32 kernel sums to "
        f"relative {KERNEL_RTOL}); outcomes {aborts}; fragments {cpu['q3_fragments']}")
    return {"k1_launches": k1_launches, "k2_launches": k2_launches}


# -- phase 5m: the schedule license, bucketed layouts, the lock graph ------------

#: phase 5m's layouts: orders and lineitem bucketed on their order key
SCHEDULE_LAYOUTS = "tpch.sf1.orders:o_orderkey:8,tpch.sf1.lineitem:l_orderkey:8"
#: phase 5m's lineitem-orders join (M2) and its twin over the bucketed CTAS
COLOCATED_JOIN = (
    "select count(*), sum(l_quantity), sum(o_totalprice) from lineitem join orders "
    "on l_orderkey = o_orderkey"
)
COLOCATED_CTAS = (
    "create table memory.default.m2_orders with (bucketed_by = array['o_orderkey'], "
    "bucket_count = 8) as select " + ORDERS_COLUMNS + " from tpch.sf1.orders"
)
COLOCATED_MEMORY_JOIN = (
    "select count(*), sum(l_quantity), sum(o_totalprice) from memory.default.m2_orders "
    "join lineitem on l_orderkey = o_orderkey"
)
#: phase 5m's M3: the aggregation by l_orderkey, its top groups
COLOCATED_AGG = (
    "select l_orderkey, sum(l_quantity), count(*) from lineitem group by l_orderkey "
    "order by 2 desc, 1 limit 20"
)
#: phase 5m's M1 queries on the 4-worker mesh, and its timed runs a side
LICENSE_QIDS = (3, 5, 18)
LICENSE_RUNS = 30


def run_schedule_layout_path(reference, probe_record: dict) -> dict:
    """Phase 5m (see the module docstring, M1-M4) on the card at tpch.sf1.
    The kernels' counts are set to 0 just before the path and read just
    after; the untimed capture run of the co-located join is counted
    apart.  Returns the launches and the M1 rows' check against the CPU
    run (made with phases 4-5c's)."""
    import statistics
    import threading

    import trino_tpu_torch.parallel.runner as mesh_runner
    from trino_tpu_torch import verify as V
    from trino_tpu_torch.connectors.api import TableHandle
    from trino_tpu_torch.connectors.tpch.queries import QUERIES
    from trino_tpu_torch.ops import aggregation as agg
    from trino_tpu_torch.ops import grouped_sums as gs
    from trino_tpu_torch.ops import locate_sorted as ls
    from trino_tpu_torch.parallel.runner import DistributedQueryRunner
    from trino_tpu_torch.runtime.runner import LocalQueryRunner
    from trino_tpu_torch.verify.lockgraph import capture

    ls.locate_sorted.launches = 0  # every kernel count, just before the path
    gs.grouped_sums.launches = 0
    results = {}

    def run(label, runner, sql):
        k2 = ls.locate_sorted.launches
        t0 = time.perf_counter()
        res = runner.execute(sql)
        wall = time.perf_counter() - t0
        c = dict(runner.last_mesh_profile.counters)
        n = ls.locate_sorted.launches - k2
        log(f"schedule {label}: wall_s={wall!r} locate_sorted_launches={n} "
            f"collective_async={c.get('collective_async', 0)} mesh_events={c}")
        return res, n, c, wall

    # -- M1: the schedule license, mesh Q3, Q5 and Q18 ------------------------------
    mesh = DistributedQueryRunner(catalog="tpch", schema="sf1", n_workers=MESH_WORKERS)
    for qid in LICENSE_QIDS:
        for attempt in ("cold", "warm"):
            res, n, c, _ = run(f"M1 q{qid} {attempt}", mesh, QUERIES[qid])
            lic = mesh.last_schedule_license
            if lic is None or c.get("collective_async", 0) != lic.licensed_count() or not n:
                raise AssertionError(
                    f"M1 q{qid} {attempt}: collective_async {c.get('collective_async')} "
                    f"against {None if lic is None else lic.async_children}, K2 {n}")
            results[f"M1_q{qid}_{attempt}"] = res
        log(f"schedule M1 q{qid}: license async_children={lic.async_children} "
            f"mesh_w={lic.mesh_w}")
    report = V.device_residency(mesh, QUERIES[3], warmups=1)
    log(f"schedule M1 q3 device_residency: {json.dumps(report['counters'])} "
        f"trace_hits={report['trace_hits']} trace_misses={report['trace_misses']} "
        f"retraces={report['retraces']} cache_keys_checked={report['cache_keys_checked']}")
    # the warm Q3 with and without the license, in turns: the license is
    # dropped here only (create_subplan's stamp cleared), no session knob
    licensed = mesh.create_subplan

    def unlicensed(plan):
        sub = licensed(plan)
        mesh.last_schedule_license = None
        return sub

    walls = {"licensed": [], "unlicensed": []}
    for i in range(2 * LICENSE_RUNS):
        side = ("licensed", "unlicensed")[i % 2]
        mesh.create_subplan = licensed if side == "licensed" else unlicensed
        t0 = time.perf_counter()
        res = mesh.execute(QUERIES[3])
        walls[side].append(time.perf_counter() - t0)
        async_n = mesh.last_mesh_profile.counters.get("collective_async", 0)
        if (async_n > 0) != (side == "licensed"):
            raise AssertionError(f"M1 timing {side}: collective_async {async_n}")
        rows_match(res.rows, results["M1_q3_warm"].rows, 0.0)
    del mesh.create_subplan
    medians = {k: statistics.median(v) for k, v in walls.items()}
    log(f"schedule M1 q3 warm over {LICENSE_RUNS} runs a side: "
        f"licensed_median_s={medians['licensed']!r} "
        f"unlicensed_median_s={medians['unlicensed']!r} "
        f"licensed_min_s={min(walls['licensed'])!r} unlicensed_min_s={min(walls['unlicensed'])!r}")

    # -- M2: bucketed layouts and co-located joins ------------------------------------
    run(f"M2 join unbucketed cold", mesh, COLOCATED_JOIN)
    plain_join, _, _, _ = run(f"M2 join unbucketed warm", mesh, COLOCATED_JOIN)
    lay = DistributedQueryRunner(catalog="tpch", schema="sf1", n_workers=MESH_WORKERS)
    lay.execute(f"set session table_layouts = '{SCHEDULE_LAYOUTS}'")
    lay.execute("set session colocated_join = true")

    def colocated(label, sql, expected):
        for attempt in ("cold", "warm"):
            res, n, c, _ = run(f"M2 {label} {attempt}", lay, sql)
            if c.get("repartition_collective", 0) or c.get("exchange_elided", 0) < 2:
                raise AssertionError(f"M2 {label} {attempt}: not co-located: {c}")
            if n != MESH_WORKERS:
                raise AssertionError(f"M2 {label} {attempt}: {n} K2 launches, "
                                     f"not one per worker shard")
            rows_match(res.rows, expected, 0.0)

    colocated("join", COLOCATED_JOIN, plain_join.rows)
    for qid in (3, 18):
        for attempt in ("cold", "warm"):
            res, _, _, _ = run(f"M2 q{qid} {attempt}", lay, QUERIES[qid])
            rows_match(res.rows, results[f"M1_q{qid}_warm"].rows, 0.0)
    log(f"schedule M2 q3 fragments:\n{lay.explain_distributed(QUERIES[3])}")
    t0 = time.perf_counter()
    ctas = lay.execute(COLOCATED_CTAS).rows
    ctas_wall = time.perf_counter() - t0
    layout = lay.catalogs.get("memory").table_layout(
        TableHandle("memory", "default", "m2_orders"))
    log(f"schedule M2 bucketed CTAS: rows={ctas} wall_s={ctas_wall!r} layout={layout}")
    if ctas != [(1_500_000,)] or layout is None:
        raise AssertionError(f"M2 CTAS: {ctas} {layout}")
    colocated("memory join", COLOCATED_MEMORY_JOIN, plain_join.rows)

    # -- M3: the co-located aggregation by l_orderkey -----------------------------------
    plain_agg, _, _, _ = run("M3 agg unbucketed", mesh, COLOCATED_AGG)
    plan_text = lay.explain_distributed(COLOCATED_AGG)
    if "Aggregation[single]" not in plan_text or "repartition" in plan_text:
        raise AssertionError(f"M3: not one stage:\n{plan_text}")
    for attempt in ("cold", "warm"):
        k1 = gs.grouped_sums.launches
        agg.GROUP_PATHS.clear()
        res, _, c, _ = run(f"M3 agg {attempt}", lay, COLOCATED_AGG)
        if c.get("repartition_collective", 0) or c.get("agg_partial_states", 0) \
                or c.get("agg_single_stage", 0):
            raise AssertionError(f"M3 {attempt}: not the co-located stage: {c}")
        rows_match(res.rows, plain_agg.rows, 0.0)
        log(f"schedule M3 {attempt}: group paths={dict(agg.GROUP_PATHS)} "
            f"grouped_sums_launches={gs.grouped_sums.launches - k1}")

    # -- M4: phase 5l's L4 under the lock graph -----------------------------------------
    cpu = reference("5l")
    done, errors = [], []
    with capture() as graph:
        from trino_tpu_torch.runtime.dispatcher import QueryDispatcher
        from trino_tpu_torch.runtime.resource_groups import (
            ResourceGroupConfig,
            ResourceGroupManager,
        )

        primary = LocalQueryRunner(catalog="tpch", schema="sf1")
        primary.execute("set session pallas_agg = true")
        for name in LIFECYCLE_DISPATCH:
            primary.execute(lifecycle_sql(name))  # warm every statement first
        groups = ResourceGroupManager()
        groups.add(ResourceGroupConfig("etl", hard_concurrency=1, weight=1, max_queued=16))
        groups.add(ResourceGroupConfig("adhoc", hard_concurrency=2, weight=3, max_queued=16))
        dispatcher = QueryDispatcher(primary, groups, lanes=2)
        primary.dispatcher = dispatcher
        jobs = [(("etl", "adhoc")[i % 2], LIFECYCLE_DISPATCH[i % 4]) for i in range(12)]
        out = threading.Lock()

        def client(k: int) -> None:
            for group, name in jobs[k::6]:
                try:
                    t = dispatcher.enqueue(group_name=group)
                    t.wait()
                    res = dispatcher.run_admitted(t, lambda r, n=name: r.execute(lifecycle_sql(n)))
                    with out:
                        done.append((name, res))
                except BaseException as e:  # noqa: BLE001 - raised after the join
                    with out:
                        errors.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,), name=f"m4-client-{k}",
                                    daemon=True) for k in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        m4_wall = time.perf_counter() - t0
        if not dispatcher.drain(wait_s=5.0, grace_s=0.0):
            raise AssertionError("M4: the dispatcher did not drain clean")
    if errors:
        raise errors[0]
    if len(done) != 12:
        raise AssertionError(f"M4: {len(done)} statements")
    for name, res in done:
        rows_match(res.rows, cpu[name], KERNEL_RTOL if name == "q1_double" else 0.0)
    edges = graph.edges()
    log(f"schedule M4 lock graph: 12 statements on 2 lanes wall_s={m4_wall!r} "
        f"edges={len(edges)} locks={len({n for e in edges for n in e})} "
        f"cycles={graph.cycles()}")
    for (a, b), witness in sorted(edges.items()):
        log(f"schedule M4 edge: {a} -> {b} ({witness})")
    graph.assert_acyclic()

    k1_launches = gs.grouped_sums.launches  # read just after the path
    k2_launches = ls.locate_sorted.launches
    # untimed, after the count was read: the co-located join's largest launch
    k2 = ls.locate_sorted.launches
    probe_kernel, probe_rec = shape_recording_probe(probe_record)
    probe_record["query"] = "M2_colocated_join"
    mesh_runner.locate_sorted = probe_rec
    try:
        lay.execute(COLOCATED_JOIN)
    finally:
        mesh_runner.locate_sorted = probe_kernel
    log(f"schedule M2 sorted-probe launches (P, cap_b, n_match, S): "
        f"{probe_record.get('shapes', {}).get('M2_colocated_join', [])} "
        f"(capture run apart: {ls.locate_sorted.launches - k2})")
    lay.execute("drop table memory.default.m2_orders")
    log(f"schedule path: grouped_sums launches={k1_launches} "
        f"locate_sorted launches={k2_launches}")
    if k2_launches <= 0:
        raise AssertionError("the schedule path never launched locate_sorted")

    def check(cpu_tpch: dict) -> None:
        for qid in LICENSE_QIDS:
            rows, _ = cpu_tpch[QUERIES[qid]]
            for attempt in ("cold", "warm"):
                rows_match(results[f"M1_q{qid}_{attempt}"].rows, rows, 0.0)
        log("schedule path: M1's Q3, Q5 and Q18 match the CPU run; M2 and M3 match M1 "
            "and the unbucketed runs")

    return {"k1_launches": k1_launches, "k2_launches": k2_launches, "check": check}


# -- phase 5n: fault-tolerant execution and the observatory ----------------------

#: phase 5n's N1 queries on the 4-worker mesh under retry_policy = 'TASK'
FTE_QIDS = (3, 18)
#: N1's cheap query whose stage never succeeds (nation grouped by region)
FTE_CHEAP = (
    "select n_regionkey, count(*) c, sum(n_nationkey) s from nation group by n_regionkey"
)
#: N1's warm Q3 walls with and without TASK, in turns
FTE_TIMED_RUNS = 5


def join_fragments(mesh, sql: str) -> tuple:
    """(build-side fragment, probe-side fragment) of the first join of
    `sql`'s mesh plan whose build side is a child fragment: the fragment
    that feeds the build, and the distributed fragment holding the probe
    (the join's own, or the child that feeds it)."""
    from trino_tpu_torch.planner import plan as P
    from trino_tpu_torch.planner.fragmenter import FIXED_HASH, SOURCE, RemoteSourceNode

    sub = mesh.create_subplan(mesh.create_plan(sql))

    def walk(node):
        yield node
        for c in node.children:
            yield from walk(c)

    for frag in sub.all_fragments():
        for node in walk(frag.root):
            if isinstance(node, P.JoinNode):
                probe, build = node.left, node.right
            elif isinstance(node, P.SemiJoinNode):
                probe, build = node.source, node.filtering
            else:
                continue
            if not isinstance(build, RemoteSourceNode):
                continue
            if isinstance(probe, RemoteSourceNode):
                return build.fragment_id, probe.fragment_id
            if frag.partitioning.kind in (SOURCE, FIXED_HASH):
                return build.fragment_id, frag.id
    raise AssertionError(f"no join with a child-fragment build side:\n{sql}")


def spooled_probe_recorder(record: dict, holder: dict):
    """shape_recording_probe's stand-in, keeping only the launches made
    after the running statement rehydrated a spooled stage output."""
    kernel, recording = shape_recording_probe(record)

    def gated(build, n_match, probe, nomatch, cap_b):
        ex = holder["mesh"].last_stage_executor
        if ex is not None and ex.counters.get("spool_read", 0) > 0:
            return recording(build, n_match, probe, nomatch, cap_b)
        return kernel(build, n_match, probe, nomatch, cap_b=cap_b)

    return kernel, gated


def artifact_sums(art: dict) -> float:
    """|sum of the artifact's phases - its wall|: zero up to the last bit of
    a double sum."""
    return abs(sum(art["phases"].values()) - art["wall_s"])


def run_fte_observatory_path(probe_record: dict) -> dict:
    """Phase 5n (see the module docstring, N1 and N2) on the card at
    tpch.sf1.  The kernels' counts are set to 0 just before the path and
    read just after; the untimed capture run of N1's spooled joins is
    counted apart.  Returns the launches and the check of N1's and N2's
    rows against the CPU run (made with phases 4-5c's)."""
    import glob
    import shutil
    import statistics
    import tempfile

    import trino_tpu_torch.parallel.runner as mesh_runner
    from trino_tpu_torch import config
    from trino_tpu_torch.connectors.tpch.queries import QUERIES
    from trino_tpu_torch.kernels import build
    from trino_tpu_torch.ops import grouped_sums as gs
    from trino_tpu_torch.ops import locate_sorted as ls
    from trino_tpu_torch.parallel.runner import DistributedQueryRunner
    from trino_tpu_torch.parallel.spmd import TRACE_CACHE
    from trino_tpu_torch.runtime.config import runner_from_etc
    from trino_tpu_torch.runtime.retry import FAILURE_INJECTOR, StageFailedException
    from trino_tpu_torch.telemetry.audit import QueryAuditLog, attach_audit_log
    from trino_tpu_torch.telemetry.compile_events import OBSERVATORY
    from trino_tpu_torch.telemetry.metrics import task_retries_counter
    from trino_tpu_torch.telemetry.profile_store import attach_profile_store

    spool_glob = os.path.join(tempfile.gettempdir(), "trino_tpu_torch_spool_*")
    spools_before = set(glob.glob(spool_glob))
    mesh = DistributedQueryRunner(catalog="tpch", schema="sf1", n_workers=MESH_WORKERS)
    gs.grouped_sums.launches = 0  # every kernel count, just before the path
    ls.locate_sorted.launches = 0
    results: dict = {}

    def retries() -> dict:
        c = task_retries_counter()
        return {o: c.labels(o).value() for o in ("retry", "fail")}

    def fte_run(label, sql, inject=None):
        """One TASK run of `sql`, optionally with one armed injection."""
        FAILURE_INJECTOR.clear()
        if inject is not None:
            FAILURE_INJECTOR.inject(inject[0], times=inject[1])
        r0 = retries()
        k2 = ls.locate_sorted.launches
        t0 = time.perf_counter()
        try:
            res = mesh.execute(sql)
        finally:
            wall = time.perf_counter() - t0
            visits = {k: v for k, v in FAILURE_INJECTOR.visits.items() if k.startswith("stage:")}
            FAILURE_INJECTOR.clear()
        ex = mesh.last_stage_executor
        r1 = retries()
        out = {
            "wall": wall, "k2": ls.locate_sorted.launches - k2, "visits": visits,
            "discards": ex.dedup_discards,
            "retries": {o: r1[o] - r0[o] for o in r1},
            "spool": dict(ex.spool_stats), "counters": dict(ex.counters),
        }
        if os.path.exists(ex.spool.dir):
            raise AssertionError(f"N1 {label}: spool {ex.spool.dir} left behind")
        log(f"fte {label}: wall_s={wall!r} locate_sorted_launches={out['k2']} "
            f"visits={visits} discards={out['discards']} retries={out['retries']} "
            f"spool={out['spool']} spool_writes={out['counters'].get('spool_write', 0)} "
            f"spool_reads={out['counters'].get('spool_read', 0)}")
        return res, out

    # -- N1: task retries, spooled stage outputs, attempt dedup ---------------------
    mesh.execute("set session retry_policy = 'TASK'")
    for qid in FTE_QIDS:
        sql = QUERIES[qid]
        build_fid, probe_fid = join_fragments(mesh, sql)
        log(f"fte N1 q{qid}: build-side fragment {build_fid}, probe-side fragment "
            f"{probe_fid}\n{mesh.explain_distributed(sql)}")
        runs = {
            "clean": None,
            "finish": (f"stage:{build_fid}:finish", 1),
            "spooled": (f"stage:{probe_fid}:spooled", 1),
        }
        for kind, inject in runs.items():
            res, out = fte_run(f"N1 q{qid} {kind}", sql, inject)
            results[f"N1_q{qid}_{kind}"] = res
            failed = {"clean": None, "finish": build_fid, "spooled": probe_fid}[kind]
            for point, n in out["visits"].items():
                if point.count(":") != 1:
                    continue  # the :finish and :spooled points
                want = 2 if point == f"stage:{failed}" else 1
                if n != want:
                    raise AssertionError(f"N1 q{qid} {kind}: {point} visited {n} times")
            if out["discards"] != (1 if kind == "spooled" else 0):
                raise AssertionError(f"N1 q{qid} {kind}: {out['discards']} discards")
            if out["retries"] != {"retry": 0 if failed is None else 1, "fail": 0}:
                raise AssertionError(f"N1 q{qid} {kind}: retries {out['retries']}")
            if not out["k2"] or not out["counters"].get("spool_read"):
                raise AssertionError(f"N1 q{qid} {kind}: K2 {out['k2']} after "
                                     f"{out['counters'].get('spool_read')} spool reads")
    try:
        fte_run("N1 cheap times=4", FTE_CHEAP, ("stage:0", 4))
    except StageFailedException as e:
        log(f"fte N1 cheap: {type(e).__name__}: {e}")
        if "after 4 attempts" not in str(e):
            raise
    else:
        raise AssertionError("N1 cheap: four failed attempts did not raise")
    # the warm Q3 with and without TASK, in turns
    walls = {"task": [], "none": []}
    for i in range(2 * FTE_TIMED_RUNS):
        side = ("task", "none")[i % 2]
        mesh.execute("set session retry_policy = " + ("'TASK'" if side == "task" else "'NONE'"))
        t0 = time.perf_counter()
        res = mesh.execute(QUERIES[3])
        walls[side].append(time.perf_counter() - t0)
        rows_match(res.rows, results["N1_q3_clean"].rows, 0.0)
        if side == "task":
            st = mesh.last_stage_executor.spool_stats
            log(f"fte N1 q3 warm TASK run: wall_s={walls[side][-1]!r} spool={st}")
    mesh.execute("set session retry_policy = 'NONE'")
    medians = {k: statistics.median(v) for k, v in walls.items()}
    log(f"fte N1 q3 warm over {FTE_TIMED_RUNS} runs a side: task_median_s={medians['task']!r} "
        f"none_median_s={medians['none']!r} task_min_s={min(walls['task'])!r} "
        f"none_min_s={min(walls['none'])!r}")
    leaked = set(glob.glob(spool_glob)) - spools_before
    if leaked:
        raise AssertionError(f"N1: spool directories left behind: {sorted(leaked)}")

    # -- N2: the profile archive, the audit log, the observatory, the ledger --------
    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "build", "chip_smoke_5n")
    shutil.rmtree(work, ignore_errors=True)
    etc = os.path.join(work, "etc")
    os.makedirs(os.path.join(etc, "catalog"))
    archive, audit_path = os.path.join(work, "archive"), os.path.join(work, "audit.jsonl")
    with open(os.path.join(etc, "config.properties"), "w") as f:
        f.write(f"default.catalog=tpch\ndefault.schema=sf1\n"
                f"profile.archive-dir={archive}\naudit.log-path={audit_path}\n")
    with open(os.path.join(etc, "catalog", "tpch.properties"), "w") as f:
        f.write("connector.name=tpch\n")
    local = runner_from_etc(etc)
    store = local.profile_store
    audit = next(l for l in local.events.listeners if isinstance(l, QueryAuditLog))
    if store is None or local.device.type != "cuda":
        raise AssertionError(f"N2: store {store}, device {local.device}")
    # K1's path, set without a statement: every statement of N2 leaves an
    # artifact and an audit line
    local.properties.set("pallas_agg", True)
    n_mesh = DistributedQueryRunner(catalog="tpch", schema="sf1", n_workers=MESH_WORKERS)
    attach_profile_store(n_mesh, store)
    attach_audit_log(n_mesh, audit)
    # a cold start in this process: the step cache emptied, every kernel
    # library forgotten (its next launch loads it again)
    TRACE_CACHE.clear()
    unloaded = build.unload_all()
    mark = OBSERVATORY.mark()
    statements = []
    for attempt in ("cold", "warm"):
        before = OBSERVATORY.count
        for label, runner, sql in (("q1_double", local, Q1_DOUBLE),
                                   ("q3_mesh", n_mesh, QUERIES[3])):
            k1, k2 = gs.grouped_sums.launches, ls.locate_sorted.launches
            t0 = time.perf_counter()
            res = runner.execute(sql)
            wall = time.perf_counter() - t0
            statements.append(runner.last_query.query_id)
            results[f"N2_{label}_{attempt}"] = res
            log(f"observatory N2 {label} {attempt}: wall_s={wall!r} "
                f"artifact_assembly_s={runner.last_artifact_s!r} "
                f"grouped_sums={gs.grouped_sums.launches - k1} "
                f"locate_sorted={ls.locate_sorted.launches - k2} "
                f"compile_events={OBSERVATORY.count - before}")
        if attempt == "warm" and OBSERVATORY.count != before:
            raise AssertionError(f"N2 warm runs recorded {OBSERVATORY.count - before} "
                                 f"compile events: {OBSERVATORY.events_above(before)}")
    if not store.flush(30.0):
        raise AssertionError("N2: the archive writer did not drain")
    arts = [store.get(q) for q in statements]
    files = sorted(os.listdir(archive))
    if len(files) != len(statements) or any(a is None for a in arts):
        raise AssertionError(f"N2: {len(files)} artifacts for {len(statements)} statements")
    for a in arts:
        with open(os.path.join(archive, a["key"] + ".json")) as f:
            on_disk = json.load(f)
        err = artifact_sums(on_disk)
        if err > 1e-12 * max(1.0, on_disk["wall_s"]) or not on_disk["peak_memory_bytes"]:
            raise AssertionError(f"N2 {a['query_id']}: phases off the wall by {err!r}, "
                                 f"peak {on_disk['peak_memory_bytes']}")
        log(f"observatory N2 artifact {a['query_id']}: wall_s={on_disk['wall_s']!r} "
            f"phases={on_disk['phases']} |sum-wall|={err!r} "
            f"peak_memory_bytes={on_disk['peak_memory_bytes']} "
            f"compile_s={on_disk['compile']['compile_s']!r} "
            f"decisions={len((on_disk['decisions'] or {}).get('decisions', []))}")
    with open(audit_path) as f:
        lines = [json.loads(line) for line in f]
    seqs = [line["seq"] for line in lines]
    if [line["query_id"] for line in lines] != statements[: len(lines)] or len(lines) != len(
        statements
    ) or any(b <= a for a, b in zip(seqs, seqs[1:])):
        raise AssertionError(f"N2 audit: {[(l['query_id'], l['seq']) for l in lines]}")
    comp = local.execute(
        f"select seq, step, bucket, mesh, query_id, fragment, wall_s "
        f"from system.runtime.compilations where seq > {mark}"
    ).rows
    kernel_rows = sorted({r[1] for r in comp if r[1].startswith("kernel:")})
    if kernel_rows != sorted(f"kernel:{n}" for n in unloaded) or len(comp) < 2:
        raise AssertionError(f"N2 compilations: kernel rows {kernel_rows}, "
                             f"libraries forgotten {unloaded}, {len(comp)} rows")
    steps = sorted({r[1] for r in comp})
    log(f"observatory N2 compilations: {len(comp)} rows since the cold start, "
        f"steps={steps}, kernel rows="
        f"{[(r[1], r[6]) for r in comp if r[1].startswith('kernel:')]}, "
        f"step seconds={sum(r[6] for r in comp if not r[1].startswith('kernel:'))!r}")
    q3_ids = statements[1::2]  # cold q1, cold q3, warm q1, warm q3
    dec = local.execute(
        "select query_id, decision_id, kind, site, choice, alternative, exchange_bytes, "
        "bytes_by, hindsight, hindsight_detail from system.runtime.plan_decisions"
    ).rows
    joins = [r for r in dec if r[0] in q3_ids and r[2] == "join_distribution"]
    if len(joins) != 2 * len(q3_ids) or any(r[6] <= 0 or not r[8] for r in joins):
        raise AssertionError(f"N2 plan_decisions: {joins}")
    for r in dec:
        if r[0] in q3_ids[:1]:
            log(f"observatory N2 decision {r}")
    prof = local.execute(
        "select query_id, state, wall_s, mesh, peak_memory_bytes, archived_path "
        "from system.runtime.query_profiles"
    ).rows
    listed = {r[0] for r in prof}
    if not set(statements) <= listed:
        raise AssertionError(f"N2 query_profiles: {sorted(listed)} lacks "
                             f"{sorted(set(statements) - listed)}")
    log(f"observatory N2 query_profiles: {len(prof)} rows, statements {statements}")
    config.reset_config()
    shutil.rmtree(work, ignore_errors=True)

    k1_launches = gs.grouped_sums.launches  # read just after the path
    k2_launches = ls.locate_sorted.launches
    # untimed, after the count was read: the largest launch fed by a spool
    holder = {"mesh": mesh}
    mesh.execute("set session retry_policy = 'TASK'")
    k2 = ls.locate_sorted.launches
    kernel, gated = spooled_probe_recorder(probe_record, holder)
    mesh_runner.locate_sorted = gated
    try:
        for qid in FTE_QIDS:
            probe_record["query"] = f"N1_q{qid}_spooled"
            mesh.execute(QUERIES[qid])
    finally:
        mesh_runner.locate_sorted = kernel
        mesh.execute("set session retry_policy = 'NONE'")
    log(f"fte N1 sorted-probe launches after a spool read (P, cap_b, n_match, S): "
        f"{probe_record.get('shapes', {})} (capture runs apart: "
        f"{ls.locate_sorted.launches - k2})")
    log(f"fte/observatory path: grouped_sums launches={k1_launches} "
        f"locate_sorted launches={k2_launches}")
    if k1_launches <= 0 or k2_launches <= 0:
        raise AssertionError("the FTE/observatory path never launched a kernel")

    def check(cpu_tpch: dict) -> None:
        for qid in FTE_QIDS:
            rows, _ = cpu_tpch[QUERIES[qid]]
            for kind in ("clean", "finish", "spooled"):
                rows_match(results[f"N1_q{qid}_{kind}"].rows, rows, 0.0)
        for attempt in ("cold", "warm"):
            rows_match(results[f"N2_q1_double_{attempt}"].rows, cpu_tpch[Q1_DOUBLE][0],
                       KERNEL_RTOL)
            rows_match(results[f"N2_q3_mesh_{attempt}"].rows, cpu_tpch[QUERIES[3]][0], 0.0)
        log("fte/observatory path: N1's Q3 and Q18 (clean, :finish, :spooled) and N2's "
            "Q1-double and mesh Q3 match the CPU run")

    return {"k1_launches": k1_launches, "k2_launches": k2_launches, "check": check}


# -- phase 5o: serving on the card ------------------------------------------------

#: O1's users and passwords (the server's PasswordAuthenticator)
SERVE_USERS = {"alice": "alice-pw", "admin": "admin-pw"}
#: O1's access-control file: alice may SELECT tpch only, admin anything
SERVE_RULES = {"tables": [
    {"user": "alice", "catalog": "tpch", "privileges": ["SELECT"]},
    {"user": "admin", "privileges": ["SELECT", "INSERT", "UPDATE", "DELETE", "OWNERSHIP"]},
]}
#: O1's engine lanes, and O3's concurrent DB-API clients
SERVE_LANES = 2
SERVE_CLIENTS = 8
#: O4: about 100,000 lineitem rows in key order, paged by the coordinator
SERVE_PAGED = (
    "select l_orderkey, l_linenumber, l_quantity, l_extendedprice, l_discount, "
    "l_shipdate, l_returnflag, l_comment from lineitem where l_orderkey <= 25000 "
    "order by l_orderkey, l_linenumber"
)
#: O1's admin statements, each with what its rows must hold: ("has", row),
#: ("lacks", row) or ("rows", rows)
SERVE_ROLE_STEPS = (
    ("create role analysts", None),
    ("grant select on tpch.sf1.nation to analysts", None),
    ("grant analysts to alice", None),
    ("show grants", ("has", ("analysts", "SELECT", "tpch", "sf1", "nation"))),
    ("revoke select on tpch.sf1.nation from analysts", None),
    ("show grants", ("lacks", ("analysts", "SELECT", "tpch", "sf1", "nation"))),
    ("show roles", ("rows", [("analysts",)])),
    ("drop role analysts", None),
    ("show roles", ("rows", [])),
)
#: O5's verifier suite
SERVE_VERIFIED = (1, 3, 6, 18)


def served_exchange(url: str, sql: str, headers: dict) -> dict:
    """One statement over raw HTTP with the timing of every request: POST,
    then nextUri to the end.  Returns the decoded rows, the page count, each
    request's (seconds, carried data) and the client's decode seconds."""
    import urllib.request

    from trino_tpu_torch.server import protocol

    t_post = time.time()
    requests, pages, data, columns, decode_s = [], 0, [], None, 0.0
    path, method, body = "/v1/statement", "POST", sql.encode()
    qid = None
    while path is not None:
        req = urllib.request.Request(url + path, data=body, method=method, headers=headers)
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as resp:
            raw = resp.read()
        got = time.perf_counter() - t0
        t1 = time.perf_counter()
        doc = json.loads(raw)
        if doc.get("error"):
            raise AssertionError(f"served {sql[:60]!r}: {doc['error'].get('message')}")
        qid = doc["id"]
        columns = doc.get("columns", columns)
        if "data" in doc:
            data.extend(protocol.decode_rows(doc["data"], columns))
            pages += 1
        decode_s += time.perf_counter() - t1
        requests.append((got, "data" in doc, len(raw)))
        path, method, body = doc.get("nextUri"), "GET", None
    return {"rows": data, "pages": pages, "requests": requests, "decode_s": decode_s,
            "t_post": t_post, "t_end": time.time(), "qid": qid}


class _DbapiEngine:
    """An `.execute(sql)` engine over a DB-API connection (the verifier's
    test side): the rows of the cursor."""

    def __init__(self, conn):
        self.conn = conn

    def execute(self, sql: str):
        return self.conn.cursor().execute(sql).fetchall()


def run_serving_path() -> dict:
    """Phase 5o (see the module docstring, O1-O5) on the card at tpch.sf1:
    the port's coordinators on 127.0.0.1 with ephemeral ports.  The
    kernels' counts are set to 0 just before the path and read just after.
    Returns the launches and the check of O1's, O2's and O3's rows against
    the CPU run (made with phases 4-5c's)."""
    import base64
    import shutil
    import statistics
    import threading
    import urllib.error
    import urllib.request

    from trino_tpu_torch import config, dbapi
    from trino_tpu_torch.client import Client, QueryFailed
    from trino_tpu_torch.connectors.tpch.queries import QUERIES
    from trino_tpu_torch.ops import grouped_sums as gs
    from trino_tpu_torch.ops import locate_sorted as ls
    from trino_tpu_torch.parallel.runner import DistributedQueryRunner
    from trino_tpu_torch.runtime.config import runner_from_etc
    from trino_tpu_torch.runtime.runner import LocalQueryRunner
    from trino_tpu_torch.server import CoordinatorServer, protocol
    from trino_tpu_torch.server.proxy import ProxyServer
    from trino_tpu_torch.server.security import PasswordAuthenticator
    from trino_tpu_torch.testing.verifier import Verifier

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "build", "chip_smoke_5o")
    shutil.rmtree(work, ignore_errors=True)
    etc = os.path.join(work, "etc")
    os.makedirs(os.path.join(etc, "catalog"))
    rules = os.path.join(work, "rules.json")
    with open(rules, "w") as f:
        json.dump(SERVE_RULES, f)
    with open(os.path.join(etc, "config.properties"), "w") as f:
        f.write(f"default.catalog=tpch\ndefault.schema=sf1\naccess-control.config-file={rules}\n"
                f"dispatcher.lanes={SERVE_LANES}\nsession.pallas_agg=true\n")
    for name in ("tpch", "memory"):
        with open(os.path.join(etc, "catalog", f"{name}.properties"), "w") as f:
            f.write(f"connector.name={name}\n")
    local = runner_from_etc(etc)
    if local.device.type != "cuda" or type(local.access_control).__name__ != (
            "RuleBasedAccessControl"):
        raise AssertionError(f"O1: runner on {local.device}, {local.access_control}")
    in_process = LocalQueryRunner(catalog="tpch", schema="sf1")
    mesh = DistributedQueryRunner(catalog="tpch", schema="sf1", n_workers=MESH_WORKERS)
    creds = {u: {"Authorization": "Basic " + base64.b64encode(f"{u}:{p}".encode()).decode()}
             for u, p in SERVE_USERS.items()}
    results: dict = {}
    started: list = []
    gs.grouped_sums.launches = 0  # every kernel count, just before the path
    ls.locate_sorted.launches = 0
    try:
        srv = CoordinatorServer(runner=local, port=0,
                                authenticator=PasswordAuthenticator(SERVE_USERS))
        srv.start()
        started.append(srv)
        if srv.dispatcher.lanes != SERVE_LANES:
            raise AssertionError(f"O1: {srv.dispatcher.lanes} lanes")
        url = f"http://127.0.0.1:{srv.port}"
        alice = Client(url, user="alice", password=SERVE_USERS["alice"])
        admin = Client(url, user="admin", password=SERVE_USERS["admin"])

        # -- O1: an etc/-configured runner behind authentication and rules ------
        for name, sql in (("q1", QUERIES[1]), ("q6", QUERIES[6]), ("q1_double", Q1_DOUBLE)):
            for attempt in ("cold", "warm"):
                k1 = gs.grouped_sums.launches
                t0 = time.perf_counter()
                _, rows = alice.execute(sql)
                wall = time.perf_counter() - t0
                k1 = gs.grouped_sums.launches - k1
                results[f"O1_{name}_{attempt}"] = rows
                log(f"serving O1 {name} {attempt} (alice over HTTP): wall_s={wall!r} "
                    f"rows={len(rows)} grouped_sums={k1}")
                if name == "q1_double" and k1 == 0:
                    raise AssertionError(f"O1 {name} {attempt}: no grouped_sums launch")
        for who, headers in (("a wrong password", {"Authorization": "Basic " + base64.b64encode(
                b"alice:wrong").decode()}), ("no credentials", {})):
            req = urllib.request.Request(url + "/v1/statement", data=b"select 1",
                                         method="POST", headers=headers)
            try:
                urllib.request.urlopen(req, timeout=60)
            except urllib.error.HTTPError as e:
                if e.code != 401:
                    raise
                log(f"serving O1 {who}: HTTP {e.code} {json.loads(e.read())['error']}")
            else:
                raise AssertionError(f"O1: {who} was not refused")
        try:
            alice.execute("create table memory.default.t as select * from nation")
        except QueryFailed as e:
            err = e.error
            log(f"serving O1 alice's CTAS: {err['errorName']} {err['errorType']} "
                f"{err['errorCode']}: {err['message']}")
            if err["errorName"] != "AccessDeniedError" or "lacks INSERT" not in err["message"]:
                raise
        else:
            raise AssertionError("O1: alice's CTAS was not denied")
        _, tables = admin.execute("show tables from memory.default")
        if ("t",) in tables:
            raise AssertionError(f"O1: the denied CTAS created a table: {tables}")
        for sql, want in SERVE_ROLE_STEPS:
            names, rows = admin.execute(sql)
            log(f"serving O1 admin {sql!r}: {names} {rows}")
            if want is not None and not {
                "has": lambda: want[1] in rows, "lacks": lambda: want[1] not in rows,
                "rows": lambda: rows == want[1],
            }[want[0]]():
                raise AssertionError(f"O1 {sql!r}: {rows} does not hold {want}")

        # -- O2: the 4-worker mesh behind a coordinator ---------------------------
        msrv = CoordinatorServer(runner=mesh, port=0)
        msrv.start()
        started.append(msrv)
        mclient = Client(f"http://127.0.0.1:{msrv.port}")
        for qid in (3, 18):
            for attempt in ("cold", "warm"):
                k2 = ls.locate_sorted.launches
                t0 = time.perf_counter()
                _, rows = mclient.execute(QUERIES[qid])
                wall = time.perf_counter() - t0
                k2 = ls.locate_sorted.launches - k2
                results[f"O2_q{qid}_{attempt}"] = rows
                log(f"serving O2 mesh q{qid} {attempt}: wall_s={wall!r} rows={len(rows)} "
                    f"locate_sorted={k2}")
                if k2 == 0:
                    raise AssertionError(f"O2 q{qid} {attempt}: no locate_sorted launch")

        # -- O3: eight DB-API clients at once, on 2 lanes --------------------------
        def q6_client(out: list, i: int, barrier=None):
            conn = dbapi.connect(url, user="alice", password=SERVE_USERS["alice"])
            if barrier is not None:
                barrier.wait()
            t0 = time.perf_counter()
            out[i] = (conn.cursor().execute(QUERIES[6]).fetchall(), time.perf_counter() - t0)

        serial = [None] * SERVE_CLIENTS
        t0 = time.perf_counter()
        for i in range(SERVE_CLIENTS):
            q6_client(serial, i)
        serial_wall = time.perf_counter() - t0
        concurrent = [None] * SERVE_CLIENTS
        barrier = threading.Barrier(SERVE_CLIENTS)
        threads = [threading.Thread(target=q6_client, args=(concurrent, i, barrier))
                   for i in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        concurrent_wall = time.perf_counter() - t0
        if any(c is None for c in concurrent):
            raise AssertionError("O3: a client did not finish")
        results["O3"] = [c[0] for c in serial + concurrent]
        log(f"serving O3 q6 x{SERVE_CLIENTS} over dbapi on {SERVE_LANES} lanes: "
            f"concurrent_wall_s={concurrent_wall!r} serial_wall_s={serial_wall!r} "
            f"serial_median_s={statistics.median(c[1] for c in serial)!r} "
            f"concurrent_client_walls_s={sorted(c[1] for c in concurrent)}")

        # -- O4: a paged result of ~100,000 rows ------------------------------------
        encode = {"s": 0.0, "pages": 0}
        plain_encode = protocol.encode_rows

        def timed_encode(rows):
            t = time.perf_counter()
            out = plain_encode(rows)
            encode["s"] += time.perf_counter() - t
            encode["pages"] += 1
            return out

        walls = []
        for _ in range(2):  # the first run stages the scan
            t0 = time.perf_counter()
            expect = in_process.execute(SERVE_PAGED).rows
            walls.append(time.perf_counter() - t0)
        in_wall = walls[-1]
        page_rows = config.get_config().coordinator.result_page_rows
        served = None
        for attempt in ("cold", "warm"):
            encode.update(s=0.0, pages=0)
            protocol.encode_rows = timed_encode
            try:
                t0 = time.perf_counter()
                served = served_exchange(url, SERVE_PAGED, creds["alice"])
                wall = time.perf_counter() - t0
            finally:
                protocol.encode_rows = plain_encode
            rows_match(served["rows"], expect, 0.0)
            if served["pages"] != -(-len(expect) // page_rows):
                raise AssertionError(f"O4: {served['pages']} pages for {len(expect)} rows")
            ctx = srv.query(served["qid"]).lifecycle
            hist = next(e for e in local.query_history.entries if e["query_id"] == ctx.query_id)
            waits = [s for s, has_data, _ in served["requests"][1:] if not has_data]
            data_reqs = [s for s, has_data, _ in served["requests"] if has_data]
            log(f"serving O4 {attempt}: rows={len(served['rows'])} pages={served['pages']} "
                f"page_rows={page_rows} served_wall_s={wall!r} in_process_wall_s={in_wall!r} "
                f"engine_wall_s={hist['wall_s']!r} "
                f"queued_s={hist['create_time'] - served['t_post']!r} "
                f"after_engine_s={served['t_end'] - hist['end_time']!r} "
                f"encode_s={encode['s']!r} encode_pages={encode['pages']} "
                f"client_decode_s={served['decode_s']!r} poll_waits={len(waits)} "
                f"poll_wait_s={sum(waits)!r} data_requests_s={sum(data_reqs)!r} "
                f"bytes={sum(b for _, _, b in served['requests'])} "
                f"post_s={served['requests'][0][0]!r}")
        log(f"serving O4: {len(expect)} served rows equal the in-process run's")

        # -- O5: the proxy, and the verifier against the in-process card runner ------
        proxy = ProxyServer(url).start()
        started.append(proxy)
        test = _DbapiEngine(dbapi.connect(proxy.url, user="alice",
                                          password=SERVE_USERS["alice"]))
        report = Verifier(in_process, test).run({f"q{q}": QUERIES[q] for q in SERVE_VERIFIED})
        for r in report.results:
            log(f"serving O5 verifier {r.query_id}: {r.status} control_wall_s="
                f"{r.control_wall_s!r} test_wall_s={r.test_wall_s!r} {r.detail[:200]}")
        if report.matched != len(SERVE_VERIFIED):
            raise AssertionError(f"O5: {report.summary()}")
    finally:
        for s in reversed(started):
            s.shutdown()
        config.reset_config()
        shutil.rmtree(work, ignore_errors=True)
    k1_launches = gs.grouped_sums.launches  # read just after the path
    k2_launches = ls.locate_sorted.launches
    log(f"serving path: grouped_sums launches={k1_launches} "
        f"locate_sorted launches={k2_launches}")
    if k1_launches <= 0 or k2_launches <= 0:
        raise AssertionError("the serving path never launched a kernel")

    def check(cpu_tpch: dict) -> None:
        for name, sql, rtol in (("q1", QUERIES[1], 0.0), ("q6", QUERIES[6], 0.0),
                                ("q1_double", Q1_DOUBLE, KERNEL_RTOL)):
            for attempt in ("cold", "warm"):
                rows_match(results[f"O1_{name}_{attempt}"], cpu_tpch[sql][0], rtol)
        for qid in (3, 18):
            for attempt in ("cold", "warm"):
                rows_match(results[f"O2_q{qid}_{attempt}"], cpu_tpch[QUERIES[qid]][0], 0.0)
        for rows in results["O3"]:
            rows_match(rows, cpu_tpch[QUERIES[6]][0], 0.0)
        log("serving path: O1's Q1, Q6 and Q1-double, O2's mesh Q3 and Q18 and O3's "
            "sixteen Q6 match the CPU run")

    return {"k1_launches": k1_launches, "k2_launches": k2_launches, "check": check}


# -- phase 5p: the multi-host worker tier on the card --------------------------

#: P1: tests/test_multihost.py's QUERIES (name -> SQL) at sf1
MULTIHOST_QUERIES = {
    "count": "select count(*) from lineitem",
    "group": ("select l_returnflag, l_linestatus, sum(l_quantity), count(*) "
              "from lineitem group by l_returnflag, l_linestatus"),
    "part_join": ("select count(*) from lineitem, orders where l_orderkey = o_orderkey "
                  "and o_orderstatus = 'F'"),
    "bcast_join": ("select n_name, count(*) from customer, nation "
                   "where c_nationkey = n_nationkey group by n_name"),
    "merge_sort": ("select l_orderkey, l_extendedprice from lineitem "
                   "where l_orderkey < 50 order by l_extendedprice desc, l_orderkey"),
    "topn": "select o_orderkey, o_totalprice from orders order by o_totalprice desc limit 10",
    "window": ("select l_orderkey, l_linenumber, "
               "rank() over (partition by l_orderkey order by l_extendedprice desc) r "
               "from lineitem where l_orderkey < 30"),
}
#: the cluster secret every 5p process shares (TRINO_TPU_CLUSTER_SECRET)
MULTIHOST_SECRET = "chip-smoke-5p"


def multihost_sqls() -> dict:
    """P1-P4's statements, name -> SQL (all held to the CPU run)."""
    from trino_tpu_torch.connectors.tpch.queries import QUERIES

    return {**MULTIHOST_QUERIES, "q1_double": Q1_DOUBLE, "q3": QUERIES[3],
            "q18": QUERIES[18], "q1": QUERIES[1]}


def multihost_cpu_reference(out_path: str) -> None:
    """The CPU run of phase 5p's MULTIHOST_QUERIES (its other statements
    are phases 4-5c's), pickled to `out_path` + ".multihost" as {sql:
    (rows, seconds)}."""
    import pickle

    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    cpu = LocalQueryRunner(catalog="tpch", schema="sf1", device="cpu")
    out = {}
    for sql in MULTIHOST_QUERIES.values():
        t0 = time.perf_counter()
        rows = cpu.execute(sql).rows
        out[sql] = (rows, time.perf_counter() - t0)
    path = out_path + REFERENCE_SUFFIX["5p"]
    with open(path + ".part", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".part", path)


def start_worker_process(here: str, coordinator_url: str):
    """A WorkerServer in a process of its own on the card (`python -m
    trino_tpu_torch.server.worker --device cuda --port 0`), started with
    subprocess (never forked after CUDA is up), under PYTHONHASHSEED=0, the
    cluster secret and `worker.coordinator-url`."""
    env = {**os.environ, "PYTHONHASHSEED": "0", "TRINO_TPU_CLUSTER_SECRET": MULTIHOST_SECRET,
           "TRINO_TPU_WORKER_COORDINATOR_URL": coordinator_url}
    return subprocess.Popen(
        [sys.executable, "-m", "trino_tpu_torch.server.worker", "--device", "cuda",
         "--port", "0"],
        cwd=here, env=env, stdout=subprocess.PIPE, text=True,
    )


def worker_process_url(proc, timeout_s: float = 180.0) -> str:
    """The url a worker process prints once it listens."""
    import threading

    got: dict = {}
    reader = threading.Thread(target=lambda: got.update(line=proc.stdout.readline()),
                              daemon=True, name="worker-url")
    reader.start()
    reader.join(timeout_s)
    line = got.get("line", "")
    if not line.startswith("worker listening on "):
        raise AssertionError(f"worker process {proc.pid}: {line!r} (exit {proc.poll()})")
    return line.split()[-1]


def exchange_report(flat: list) -> dict:
    """Per stage of one traced multi-host query, from its merged trace: the
    bytes its tasks serialized and the bytes pulled from it (by the
    consumers' tasks and by the coordinator), and the host seconds of the
    output's copy off the card, bucketing, serialization and decoding;
    plus the tasks per worker and the replacement tasks among them."""
    from collections import Counter

    attrs = {s["span_id"]: json.loads(s["attributes"]) if s["attributes"] else {}
             for s in flat}
    stages: dict = {}
    workers: Counter = Counter()
    replaced = 0

    def stage(fid):
        return stages.setdefault(fid, {
            "kind": None, "tasks": 0, "serialized_bytes": 0, "pulled_bytes": 0,
            "d2h_s": 0.0, "partition_s": 0.0, "encode_s": 0.0, "decode_s": 0.0})

    for s in flat:
        a = attrs[s["span_id"]]
        if s["name"] == "fragment" and "fragment_id" in a:
            st = stage(a["fragment_id"])
            st["kind"] = a.get("kind")
            st["pulled_bytes"] += a.get("pulled_bytes", 0)
            st["decode_s"] += a.get("decode_s", 0.0)
        elif s["name"] == "task":
            parent = attrs.get(s["parent_id"], {})
            st = stage(parent.get("fragment_id"))
            st["tasks"] += 1
            st["serialized_bytes"] += a.get("output_bytes", 0)
            for k in ("d2h_s", "partition_s", "encode_s"):
                st[k] += a.get(k, 0.0)
            workers[a.get("worker")] += 1
            # a replacement task's id carries r<seq> (_replace_task)
            replaced += bool(re.search(r"_w\d+r\d+$", a.get("task_id", "")))
        elif s["name"] == "input_fetch":
            st = stage(a.get("source_fragment"))
            st["pulled_bytes"] += a.get("bytes", 0)
            st["decode_s"] += a.get("decode_s", 0.0)
    return {"stages": stages, "tasks_per_worker": dict(workers), "replaced": replaced}


class _PulledBatchCheck:
    """While installed: every materialized batch list a plan reads (the
    page sets pulled over HTTP, merged shards, a coordinator-side
    fragment's output, spooled stages) is checked to lie on the card; the
    streams of the engine's own operators pass through unchecked."""

    #: the device type every checked batch must lie on
    device_type = "cuda"

    def __init__(self):
        self.checked = 0
        self.off_card: list = []

    def __enter__(self):
        import trino_tpu_torch.parallel.remote as remote
        import trino_tpu_torch.runtime.local_planner as local_planner

        check = self
        base = local_planner.PhysicalPlan

        class CheckedPlan(base):
            def __init__(self, stream, symbols):
                if type(stream).__name__ == "list_iterator":
                    stream = check.wrap(stream)
                super().__init__(stream, symbols)

        self._saved = (local_planner.PhysicalPlan, remote.PhysicalPlan)
        local_planner.PhysicalPlan = CheckedPlan
        remote.PhysicalPlan = CheckedPlan
        return self

    def wrap(self, stream):
        for b in stream:
            self.checked += 1
            planes = [c.data for c in b.columns]
            if b.row_mask is not None:
                planes.append(b.row_mask)
            if any(t.device.type != self.device_type for t in planes):
                self.off_card.append(str(b.device))
            yield b

    def __exit__(self, *exc):
        import trino_tpu_torch.parallel.remote as remote
        import trino_tpu_torch.runtime.local_planner as local_planner

        local_planner.PhysicalPlan, remote.PhysicalPlan = self._saved
        return False


def run_multihost_path(probe_record: dict, k1_capture: dict, schema: str = "sf1") -> dict:
    """Phase 5p (see the module docstring, P1-P4) on the card at tpch.sf1.
    The kernels' counts are set to 0 just before the path and read just
    after; the K1 inputs of a worker's Q1-double aggregation and
    the K2 inputs of the resized mesh's largest W = 2 launch are kept for
    phases 6a and 6.  Returns the launches and the check of every result
    against the CPU run (phases 4-5c's and its own, `multihost_cpu_reference`)."""
    import urllib.error
    import urllib.request

    from trino_tpu_torch.client import Client
    from trino_tpu_torch.ops import grouped_sums as gs
    from trino_tpu_torch.ops import locate_sorted as ls
    from trino_tpu_torch.parallel import remote
    from trino_tpu_torch.parallel.remote import MultiHostQueryRunner
    from trino_tpu_torch.parallel.runner import DistributedQueryRunner
    from trino_tpu_torch.runtime.retry import BREAKERS
    from trino_tpu_torch.server import CoordinatorServer
    from trino_tpu_torch.server.worker import WorkerServer, sign_body
    from trino_tpu_torch.telemetry.metrics import breaker_trips_counter
    from trino_tpu_torch.testing import result_order

    here = os.path.dirname(os.path.abspath(__file__))
    sqls = multihost_sqls()
    results: dict = {}
    orders: dict = {}
    secret_before = os.environ.get("TRINO_TPU_CLUSTER_SECRET")
    os.environ["TRINO_TPU_CLUSTER_SECRET"] = MULTIHOST_SECRET
    procs: dict = {}
    in_process: list = []
    servers: list = []
    gs.grouped_sums.launches = 0  # every kernel count, just before the path
    ls.locate_sorted.launches = 0
    check = _PulledBatchCheck()
    plain_fetch = remote._fetch_ok
    try:
        in_process = [WorkerServer(port=0).start() for _ in range(2)]
        if any(w.device.type != check.device_type for w in in_process):
            raise AssertionError("P1: an in-process worker is not on the card")
        mh = MultiHostQueryRunner([w.url for w in in_process], catalog="tpch", schema=schema)
        srv = CoordinatorServer(runner=mh, port=0)
        srv.start()  # the runner's heartbeat loop; /v1/dictionary, /v1/worker/*
        servers.append(srv)
        url = f"http://127.0.0.1:{srv.port}"
        # the worker processes resolve the coordinator's global dictionary
        # refs through its /v1/dictionary (`worker.coordinator-url`)
        procs = {name: start_worker_process(here, url) for name in ("A", "B")}
        urls = {name: worker_process_url(p) for name, p in procs.items()}
        log(f"multihost workers: in-process {[w.url for w in in_process]}, "
            f"processes {urls} (pids {[p.pid for p in procs.values()]})")
        mh.add_worker(urls["A"])
        mh.execute("set session query_trace = true")
        for name, sql in sqls.items():
            orders[name] = result_order(mh.create_plan(sql))

        # a task the coordinator could not pull is replaced on a live worker
        # (or the query re-plans); each such failure is logged with its text
        failures: list = []

        def noting_fetch(task, *a, **kw):
            try:
                return plain_fetch(task, *a, **kw)
            except Exception as e:
                failures.append(f"{task.task_id} on {task.worker_url}: {e}"[:3000])
                raise

        remote._fetch_ok = noting_fetch

        def run(name: str, label: str, want_w: int) -> tuple:
            trips = breaker_trips_counter().value()
            failures.clear()
            k1 = gs.grouped_sums.launches
            t0 = time.perf_counter()
            rows = mh.execute(sqls[name]).rows
            wall = time.perf_counter() - t0
            k1 = gs.grouped_sums.launches - k1
            log(f"multihost {label} {name}: breaker trips {breaker_trips_counter().value() - trips}"
                f", breakers {BREAKERS.states()}, failed pulls {len(failures)}")
            for text in failures:
                log(f"multihost {label} {name} failed pull: {text}")
            if label.startswith("P1") and failures:
                raise AssertionError(f"P1 {name}: {len(failures)} task failures")
            if len(mh.last_plan_workers) != want_w:
                raise AssertionError(f"{label} {name}: planned at W = "
                                     f"{len(mh.last_plan_workers)}, not {want_w}")
            results[f"{label}_{name}"] = (name, rows)
            return rows, wall, k1

        # -- P1: the queries over two in-process workers and one process ------
        with check:
            mh.execute("set session pallas_agg = true")
            original_launch, recording = grouped_sums_recorder(k1_capture)
            for name in list(MULTIHOST_QUERIES) + ["q1_double", "q3", "q18"]:
                for attempt in ("cold", "warm"):
                    if name == "q1_double" and attempt == "cold":
                        gs._launch = recording  # a worker's aggregation
                    try:
                        rows, wall, k1 = run(name, f"P1_{attempt}", 3)
                    finally:
                        gs._launch = original_launch
                    rep = exchange_report(mh.traces[-1][1])
                    log(f"multihost P1 {name} {attempt}: wall_s={wall!r} rows={len(rows)} "
                        f"grouped_sums={k1} replaced_tasks={rep['replaced']} "
                        f"tasks_per_worker={rep['tasks_per_worker']} "
                        f"stages={json.dumps(rep['stages'], sort_keys=True)}")
                    if name == "q1_double" and k1 == 0:
                        raise AssertionError("P1 q1_double: no grouped_sums launch in a worker")
            k1_capture["query"] = "q1_double_worker_agg"
            log(f"multihost P1: {check.checked} pulled batches read, all on the card")

            # -- P2: membership through the coordinator ---------------------------
            def put(path: str, body: bytes, signed: bool) -> tuple:
                headers = {"X-Cluster-Auth": sign_body(MULTIHOST_SECRET.encode(), body)} \
                    if signed else {}
                req = urllib.request.Request(url + path, data=body, headers=headers,
                                             method="PUT")
                try:
                    with urllib.request.urlopen(req, timeout=60) as r:
                        return r.status, json.loads(r.read())
                except urllib.error.HTTPError as e:
                    return e.code, json.loads(e.read())

            got = put("/v1/worker/register", urls["B"].encode(), signed=False)
            log(f"multihost P2 unsigned register: {got}")
            if got != (401, {"error": {"message": "bad signature"}}):
                raise AssertionError(f"P2: an unsigned register was not refused: {got}")
            got = put("/v1/worker/drain", urls["A"].encode(), signed=True)
            if got != (200, {"draining": urls["A"]}):
                raise AssertionError(f"P2: drain answered {got}")
            rows, wall, _ = run("q1", "P2_drained", 2)
            log(f"multihost P2 q1 after draining the process worker: wall_s={wall!r} "
                f"workers={mh.last_plan_workers}")
            procs["A"].wait(timeout=120)  # the drained process exits by itself
            log(f"multihost P2: the drained worker process exited {procs['A'].returncode}")
            grown = WorkerServer(port=0).start()
            in_process.append(grown)
            mh.add_worker(grown.url)
            rows, wall, _ = run("q1", "P2_grown", 3)
            log(f"multihost P2 q1 after add_worker: wall_s={wall!r} W=3")
            got = put("/v1/worker/register", urls["B"].encode(), signed=True)
            if got != (200, {"registered": urls["B"]}):
                raise AssertionError(f"P2: register answered {got}")
            original_fetch = remote._fetch_ok
            killed: dict = {}

            def killing_fetch(task, *a, **kw):
                if not killed:  # the first pull of the query: B dies now
                    procs["B"].terminate()
                    killed["rc"] = procs["B"].wait(timeout=60)
                return original_fetch(task, *a, **kw)

            remote._fetch_ok = killing_fetch
            try:
                rows, wall, _ = run("q3", "P2_killed", 3)
            finally:
                remote._fetch_ok = original_fetch
            log(f"multihost P2 q3 with the process worker killed mid-pull "
                f"(exit {killed.get('rc')}): wall_s={wall!r} replans={mh.last_replans} "
                f"W={len(mh.last_plan_workers)}")
            if mh.last_replans != 1 or urls["B"] in mh.last_plan_workers:
                raise AssertionError(f"P2: {mh.last_replans} re-plans, workers "
                                     f"{mh.last_plan_workers}")
            died = mh.failure_detector.tick()
            nodes = mh.execute("select node_id, state, heartbeat_age_s, breaker_state "
                               "from system.runtime.nodes").rows
            log(f"multihost P2 detector tick declared {died}; nodes {nodes}")
            state = {r[0]: r for r in nodes}
            if state[urls["B"]][1] != "DEAD" or state[urls["B"]][3] != "open" \
                    or BREAKERS.get(urls["B"]).state != "open":
                raise AssertionError(f"P2: the killed worker is {state[urls['B']]}")

            # -- P4: served over /v1/statement; a worker registered over HTTP -----
            fresh = WorkerServer(port=0).start()
            in_process.append(fresh)
            got = put("/v1/worker/register", fresh.url.encode(), signed=True)
            if got != (200, {"registered": fresh.url}):
                raise AssertionError(f"P4: register answered {got}")
            client = Client(url)
            for name in ("q1_double", "q3"):
                k1 = gs.grouped_sums.launches
                t0 = time.perf_counter()
                _, rows = client.execute(sqls[name])
                wall = time.perf_counter() - t0
                results[f"P4_{name}"] = (name, [tuple(r) for r in rows])
                log(f"multihost P4 {name} served: wall_s={wall!r} rows={len(rows)} "
                    f"W={len(mh.last_plan_workers)} "
                    f"grouped_sums={gs.grouped_sums.launches - k1}")
                if len(mh.last_plan_workers) != 4:
                    raise AssertionError(f"P4: planned at W = {len(mh.last_plan_workers)}")
        if check.off_card:
            raise AssertionError(f"P1-P4: {len(check.off_card)} pulled batches read off "
                                 f"the card: {sorted(set(check.off_card))}")
        log(f"multihost P1-P4: {check.checked} pulled batches read, all on the card")

        # -- P3: resize_mesh on the one-card mesh, 4 -> 2 -> 4 ----------------------
        mesh = DistributedQueryRunner(catalog="tpch", schema=schema, n_workers=MESH_WORKERS)
        kernel, recording = shape_recording_probe(probe_record)
        import trino_tpu_torch.parallel.runner as mesh_runner

        for w in (4, 2, 4):
            mesh.resize_mesh(w)
            k2 = ls.locate_sorted.launches
            if w == 2:
                probe_record["query"] = "q3_w2"
                mesh_runner.locate_sorted = recording
            try:
                t0 = time.perf_counter()
                rows = mesh.execute(sqls["q3"]).rows
                wall = time.perf_counter() - t0
            finally:
                mesh_runner.locate_sorted = kernel
            k2 = ls.locate_sorted.launches - k2
            results[f"P3_w{w}_{len(results)}"] = ("q3", rows)
            log(f"multihost P3 mesh q3 at W={w}: wall_s={wall!r} locate_sorted={k2} "
                f"scan entries dropped by the resize={mesh.last_resize_invalidated}")
            if k2 == 0:
                raise AssertionError(f"P3 W={w}: no locate_sorted launch")
    finally:
        remote._fetch_ok = plain_fetch
        for s in servers:
            s.shutdown()
        for w in in_process:
            w.shutdown()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
            p.stdout.close()
        if secret_before is None:
            os.environ.pop("TRINO_TPU_CLUSTER_SECRET", None)
        else:
            os.environ["TRINO_TPU_CLUSTER_SECRET"] = secret_before
    k1_launches = gs.grouped_sums.launches  # read just after the path
    k2_launches = ls.locate_sorted.launches
    log(f"multihost path: grouped_sums launches={k1_launches} (in-process workers) "
        f"locate_sorted launches={k2_launches}")
    if k1_launches <= 0 or k2_launches <= 0:
        raise AssertionError("the multi-host path never launched a kernel")

    def check_rows(cpu_tpch: dict) -> None:
        from trino_tpu_torch.testing import assert_rows_match

        for key, (name, rows) in results.items():
            rtol = KERNEL_RTOL if name == "q1_double" else DOUBLE_RTOL
            assert_rows_match(rows, cpu_tpch[sqls[name]][0], orders[name], rtol)
        log(f"multihost path: {len(results)} results match the CPU run")

    return {"k1_launches": k1_launches, "k2_launches": k2_launches, "check": check_rows}


# -- phase 5q: restart prewarm on the card -------------------------------------

#: phase 5q's statements: Q1-double and Q6 through a coordinator over the
#: local runner (`pallas_agg` on: Q1-double's aggregation is K1's), Q3
#: through a coordinator over the 4-worker mesh (K2 in its join)
PREWARM_LOCAL = ("q1_double", "q6")
PREWARM_MESH = ("q3",)


def prewarm_sqls() -> dict:
    from trino_tpu_torch.connectors.tpch.queries import QUERIES

    return {"q1_double": Q1_DOUBLE, "q6": QUERIES[6], "q3": QUERIES[3]}


def wait_prewarm(pw, runs_before: int, timeout_s: float = 300.0) -> None:
    """Join the executor's replay and any replay it queued behind itself;
    fails unless a replay ran since the executor had `runs_before`."""
    if not pw.wait(timeout_s):
        raise AssertionError(f"the prewarm replay ran past {timeout_s} s")
    if pw.runs <= runs_before:
        raise AssertionError("no prewarm replay was started")


def served(srv, sql: str, what: str) -> tuple:
    """One statement through a coordinator's dispatcher (the user's path):
    its wall and rows; fails unless it finished."""
    t0 = time.perf_counter()
    q = srv.submit(sql)
    if not q.done.wait(timeout=600):
        raise AssertionError(f"{what}: no answer in 600 s")
    wall = time.perf_counter() - t0
    if q.state != "FINISHED":
        raise AssertionError(f"{what}: {q.state} {q.error}")
    return wall, q.result.rows


def prewarm_card_process(out_path: str, local_loc: str, mesh_loc: str, schema: str) -> int:
    """A fresh card process of phase 5q (Q2, or Q3 when both manifest
    paths are "-"): two coordinators, one over a LocalQueryRunner and one
    over the 4-worker mesh.  Prewarmed, the local server attaches its
    executor from `prewarm.manifest-path` and the mesh runner's executor
    is attached before its server (as runner_from_etc does); each server
    replays its manifest on start through the dispatcher's system
    admission, and must reach WARM with zero compile events on the verify
    replay and K1 (local) or K2 (mesh) launched.  Then each statement's
    first real run: prewarmed, zero compile events above the watermark.
    Prewarmed, the mesh then grows 4 -> 2 -> 4 (`resize_mesh`): each kicked
    replay must reach WARM and the next Q3 build nothing.  Walls, events,
    launches and rows are pickled to `out_path`."""
    import pickle

    from trino_tpu_torch.config import install_config, load_cluster_config
    from trino_tpu_torch.ops import grouped_sums as gs
    from trino_tpu_torch.ops import locate_sorted as ls
    from trino_tpu_torch.parallel.runner import DistributedQueryRunner
    from trino_tpu_torch.runtime.prewarm import attach_prewarm
    from trino_tpu_torch.runtime.runner import LocalQueryRunner
    from trino_tpu_torch.server import CoordinatorServer
    from trino_tpu_torch.telemetry.compile_events import OBSERVATORY

    prewarmed = local_loc != "-"
    label = "prewarmed" if prewarmed else "cold"
    sqls = prewarm_sqls()
    out: dict = {"label": label, "first": {}, "replay": {}, "grow": [], "rows": {}}
    t_start = time.perf_counter()
    if prewarmed:
        install_config(load_cluster_config({"prewarm.manifest-path": local_loc}))
    local = LocalQueryRunner(catalog="tpch", schema=schema)
    local.properties.set("pallas_agg", True)
    mesh = DistributedQueryRunner(catalog="tpch", schema=schema, n_workers=MESH_WORKERS)
    if prewarmed:
        attach_prewarm(mesh, mesh_loc)
    servers = []
    gs.grouped_sums.launches = 0  # every kernel count, just before the path
    ls.locate_sorted.launches = 0
    try:
        for name, runner, names in (("local", local, PREWARM_LOCAL), ("mesh", mesh, PREWARM_MESH)):
            srv = CoordinatorServer(runner=runner, port=0)
            k1, k2, mark = gs.grouped_sums.launches, ls.locate_sorted.launches, OBSERVATORY.mark()
            t0 = time.perf_counter()
            srv.start()  # prewarmed: attaches (local) or adopts (mesh) and replays
            servers.append(srv)
            if prewarmed:
                pw = runner.prewarm
                if pw is None or pw._admission is None:
                    raise AssertionError(f"Q2 {name}: no executor adopted the dispatcher's admission")
                wait_prewarm(pw, 0)
                wall = time.perf_counter() - t0
                rep = {
                    "wall_s": wall, "state": pw.state, "runs": pw.runs,
                    "verify_events": pw.verify_events,
                    "replay_events": (pw.watermark or 0) - mark,
                    "k1": gs.grouped_sums.launches - k1, "k2": ls.locate_sorted.launches - k2,
                    "admitted": {s["name"]: s for s in srv.dispatcher.stats()}[
                        "system.prewarm"]["total_admitted"],
                }
                out["replay"][name] = rep
                log(f"prewarm Q2 {name} replay: {json.dumps(rep)}")
                if pw.state != "WARM" or pw.verify_events != 0:
                    raise AssertionError(f"Q2 {name}: replay {pw.state}, verify_events "
                                         f"{pw.verify_events} ({pw.last_error})")
                if rep["admitted"] < 1:
                    raise AssertionError(f"Q2 {name}: the replay skipped system.prewarm")
                if name == "local" and rep["k1"] <= 0:
                    raise AssertionError("Q2: the local replay never launched grouped_sums")
                if name == "mesh" and rep["k2"] <= 0:
                    raise AssertionError("Q2: the mesh replay never launched locate_sorted")
            for q in names:
                mark = OBSERVATORY.mark()
                k1, k2 = gs.grouped_sums.launches, ls.locate_sorted.launches
                wall, rows = served(srv, sqls[q], f"{label} first {q}")
                events = OBSERVATORY.mark() - mark
                steps = sorted({e.step for e in OBSERVATORY.events_above(mark)})
                first = {"wall_s": wall, "events": events, "steps": steps,
                         "k1": gs.grouped_sums.launches - k1,
                         "k2": ls.locate_sorted.launches - k2}
                out["first"][q] = first
                out["rows"][f"{label}_first_{q}"] = (q, rows)
                log(f"prewarm {label} first {q}: {json.dumps(first)}")
                if prewarmed and events:
                    raise AssertionError(f"Q2 first {q}: {events} compile events above the "
                                         f"watermark ({steps})")
        if prewarmed:
            # Q4: the mesh grows; each kicked replay builds the new signature
            srv = servers[1]
            for w in (2, 4):
                mark = OBSERVATORY.mark()
                pw = mesh.prewarm
                runs = pw.runs
                t0 = time.perf_counter()
                mesh.resize_mesh(w)
                wait_prewarm(pw, runs)
                replay_s = time.perf_counter() - t0
                built = (pw.watermark or 0) - mark
                mark = OBSERVATORY.mark()
                k2 = ls.locate_sorted.launches
                wall, rows = served(srv, sqls["q3"], f"grow W={w} q3")
                grow = {"w": w, "replay_s": replay_s, "state": pw.state,
                        "verify_events": pw.verify_events, "replay_events": built,
                        "q3_wall_s": wall, "q3_events": OBSERVATORY.mark() - mark,
                        "q3_k2": ls.locate_sorted.launches - k2}
                out["grow"].append(grow)
                out["rows"][f"grow_w{w}_q3"] = ("q3", rows)
                log(f"prewarm Q4 grow: {json.dumps(grow)}")
                if pw.state != "WARM" or pw.verify_events != 0:
                    raise AssertionError(f"Q4 W={w}: replay {pw.state} ({pw.last_error})")
                if grow["q3_events"]:
                    raise AssertionError(f"Q4 W={w}: Q3 recorded {grow['q3_events']} "
                                         f"compile events at the new signature")
                if grow["q3_k2"] <= 0:
                    raise AssertionError(f"Q4 W={w}: Q3 never launched locate_sorted")
    finally:
        for srv in servers:
            srv.shutdown()
    out["k1_launches"] = gs.grouped_sums.launches  # read just after the path
    out["k2_launches"] = ls.locate_sorted.launches
    out["seconds"] = time.perf_counter() - t_start
    with open(out_path + ".part", "wb") as f:
        pickle.dump(out, f)
    os.replace(out_path + ".part", out_path)
    return 0


def run_prewarm_card(here: str, children: list, out_path: str, args: list,
                     timeout_s: float = 300.0) -> dict:
    """Start one fresh card process of phase 5q and read its results."""
    import pickle

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, os.path.join(here, "chip_smoke.py"), "--prewarm-card", out_path, *args],
        cwd=here,
    )
    children.append(proc)
    try:
        rc = proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"the phase 5q card process ran past {timeout_s} s")
    if rc != 0 or not os.path.exists(out_path):
        raise AssertionError(f"the phase 5q card process failed with exit code {rc}")
    with open(out_path, "rb") as f:
        out = pickle.load(f)
    out["process_s"] = time.perf_counter() - t0
    return out


def run_prewarm_path(here: str, children: list, card: str = "", schema: str = "sf1") -> dict:
    """Phase 5q (see the module docstring, Q1-Q4) on the card at tpch.sf1:
    record manifests in this warm process, replay them in a fresh card
    process, take a cold baseline in another.  Returns the launches and
    the check of every result against the CPU run (phases 4-5c's)."""
    import shutil
    import tempfile

    from trino_tpu_torch.config import install_config, load_cluster_config, reset_config
    from trino_tpu_torch.ops import grouped_sums as gs
    from trino_tpu_torch.ops import locate_sorted as ls
    from trino_tpu_torch.parallel.runner import DistributedQueryRunner
    from trino_tpu_torch.runtime.prewarm import PrewarmExecutor, load_manifest
    from trino_tpu_torch.runtime.runner import LocalQueryRunner
    from trino_tpu_torch.server import CoordinatorServer
    from trino_tpu_torch.testing import result_order

    sqls = prewarm_sqls()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_5q_")
    local_loc = os.path.join(tmp, "local_manifest.json")
    mesh_loc = os.path.join(tmp, "mesh_manifest.json")
    results: dict = {}
    gs.grouped_sums.launches = 0  # every kernel count, just before the path
    ls.locate_sorted.launches = 0
    try:
        # -- Q1: record and save both manifests in this (warm) process -------
        install_config(load_cluster_config({
            "prewarm.manifest-path": local_loc, "prewarm.on-start": "false",
        }))
        local = LocalQueryRunner(catalog="tpch", schema=schema)
        local.properties.set("pallas_agg", True)
        orders = {q: result_order(local.create_plan(sql)) for q, sql in sqls.items()}
        srv = CoordinatorServer(runner=local, port=0)
        srv.start()
        try:
            for q in PREWARM_LOCAL:
                wall, rows = served(srv, sqls[q], f"record {q}")
                results[f"record_{q}"] = (q, rows)
                log(f"prewarm Q1 record {q}: wall_s={wall!r}")
        finally:
            srv.shutdown()  # saves the manifest of the served SELECTs
        reset_config()
        mesh = DistributedQueryRunner(catalog="tpch", schema=schema, n_workers=MESH_WORKERS)
        ex = PrewarmExecutor(mesh, mesh_loc)
        results["record_q3"] = ("q3", mesh.execute(sqls["q3"]).rows)
        ex.record(sqls["q3"])
        if not ex.save():
            raise AssertionError("Q1: the mesh manifest was not saved")
        for loc, want in ((local_loc, PREWARM_LOCAL), (mesh_loc, PREWARM_MESH)):
            m = load_manifest(loc)
            if m is None or m.statements != [sqls[q] for q in want]:
                raise AssertionError(f"Q1: {loc} holds {m and m.statements}")
            log(f"prewarm Q1 manifest {os.path.basename(loc)}: {len(m.statements)} "
                f"statements, {len(m.cap_history)} learned capacities, "
                f"{len(m.compile_keys)} compile keys, workers={m.workers}, "
                f"dictionaries={len((m.dictionaries or {}).get('entries') or ())}")
        k1_record, k2_record = gs.grouped_sums.launches, ls.locate_sorted.launches

        # -- Q2 and Q4: a fresh card process replays them; Q3: one without ----
        warm = run_prewarm_card(here, children, os.path.join(tmp, "prewarmed.pkl"),
                                [local_loc, mesh_loc, schema])
        cold = run_prewarm_card(here, children, os.path.join(tmp, "cold.pkl"),
                                ["-", "-", schema])
    finally:
        reset_config()
        shutil.rmtree(tmp, ignore_errors=True)
    for out in (warm, cold):
        for key, value in out["rows"].items():
            results[f"{out['label']}_{key}"] = value
    replay_s = sum(r["wall_s"] for r in warm["replay"].values())
    summary = {
        "replay_s": {k: r["wall_s"] for k, r in warm["replay"].items()},
        "first_s_prewarmed": {q: f["wall_s"] for q, f in warm["first"].items()},
        "first_s_cold": {q: f["wall_s"] for q, f in cold["first"].items()},
        "first_events_cold": {q: f["events"] for q, f in cold["first"].items()},
        "grow": [(g["w"], g["replay_s"], g["q3_wall_s"]) for g in warm["grow"]],
        "process_s": {"prewarmed": warm["process_s"], "cold": cold["process_s"]},
    }
    log(f"prewarm path ({card}): {json.dumps(summary)} (replays {replay_s!r} s)")
    k1_launches = k1_record + warm["k1_launches"] + cold["k1_launches"]
    k2_launches = k2_record + warm["k2_launches"] + cold["k2_launches"]
    log(f"prewarm path: grouped_sums launches={k1_launches} (record {k1_record}, "
        f"prewarmed process {warm['k1_launches']}, cold process {cold['k1_launches']}) "
        f"locate_sorted launches={k2_launches} (record {k2_record}, prewarmed process "
        f"{warm['k2_launches']}, cold process {cold['k2_launches']})")
    if k1_launches <= 0 or k2_launches <= 0:
        raise AssertionError("the prewarm path never launched a kernel")

    def check_rows(cpu_tpch: dict) -> None:
        from trino_tpu_torch.testing import assert_rows_match

        for key, (name, rows) in results.items():
            rtol = KERNEL_RTOL if name == "q1_double" else DOUBLE_RTOL
            assert_rows_match(rows, cpu_tpch[sqls[name]][0], orders[name], rtol)
        log(f"prewarm path: {len(results)} results match the CPU run")

    return {"k1_launches": k1_launches, "k2_launches": k2_launches,
            "replay": warm["replay"], "grow": warm["grow"], "check": check_rows}


# -- phase 6: the sorted-probe kernel against its plain version ----------------


def probe_edge_inputs(dev):
    """(name, build, n_match, probe, nomatch, cap_b) at the edges."""
    rng = np.random.default_rng(7)
    i64 = np.iinfo(np.int64)

    def sorted_build(cap_b, n_match, lo, hi, dtype=np.int64):
        keys = np.sort(rng.integers(lo, hi, n_match)).astype(dtype)
        pad = np.full(cap_b - n_match, np.iinfo(dtype).max, dtype=dtype)
        return np.concatenate([keys, pad])

    cases = []
    b = sorted_build(512, 389, 0, 64)
    cases.append(("dups_misses", b, 389, rng.integers(-4, 72, 2048), rng.random(2048) < 0.15, 512))
    cases.append(("all_nomatch", b, 389, rng.integers(0, 64, 4096), np.ones(4096, bool), 512))
    cases.append(("n_match_0", np.full(16, i64.max), 0, np.arange(64), np.zeros(64, bool), 16))
    b = sorted_build(4096, 3000, -1000, 1000)
    cases.append(("ragged_p", b, 3000, rng.integers(-1100, 1100, 1500), rng.random(1500) < 0.1, 4096))
    cases.append(("small_p", b, 3000, rng.integers(-1100, 1100, 100), np.zeros(100, bool), 4096))
    edge = np.array([i64.min, i64.min, -1, 0, 5, i64.max - 1, i64.max, i64.max])
    cases.append(("int64_extremes", edge, 8, np.array([i64.min, i64.max, 0, -1, 7, i64.max - 1, 3]), np.zeros(7, bool), 8))
    b = sorted_build(1024, 900, -50, 50, np.int32)
    cases.append(("int32_planes", b, 900, rng.integers(-60, 60, 3000).astype(np.int32), rng.random(3000) < 0.05, 1024))
    # the splitter tier (S = 8 at these planes): runs of ~10 equal keys
    # that cross window edges, a run of 100 equal keys (12 windows), and
    # n_match at 1, S - 1, S + 1 and not a multiple of S
    b = sorted_build(4096, 3000, 0, 300)
    cases.append(("runs_cross_windows", b, 3000, rng.integers(-5, 305, 8192), rng.random(8192) < 0.1, 4096))
    keys = np.sort(np.concatenate([np.full(100, 7), rng.integers(-40, 40, 900)]))
    b = np.concatenate([keys, np.full(24, i64.max)])
    cases.append(("run_of_100", b, 1000, rng.integers(-45, 45, 4096), np.zeros(4096, bool), 1024))
    for n_match in (1, 7, 9, 1003):
        b = sorted_build(1024, n_match, -20, 20)
        cases.append((f"n_match_{n_match}", b, n_match, rng.integers(-25, 25, 2048), rng.random(2048) < 0.1, 1024))
    b = sorted_build(1003, 1003, -400, 400)  # the last window is ragged
    cases.append(("plane_not_multiple_of_s", b, 1003, rng.integers(-410, 410, 2048), np.zeros(2048, bool), 1003))
    # larger planes: S = 16 (vector windows of 16 keys, two rows a thread)
    # and S = 512 (windows searched in device memory)
    b = sorted_build(1 << 17, 100_001, 0, 20_000)
    cases.append(("s16_cap_2e17", b, 100_001, rng.integers(-10, 20_010, 1 << 16), rng.random(1 << 16) < 0.2, 1 << 17))
    b = sorted_build(1 << 22, 3_000_001, 0, 1_000_000)
    cases.append(("s512_cap_2e22", b, 3_000_001, rng.integers(-10, 1_000_010, 1 << 16), rng.random(1 << 16) < 0.2, 1 << 22))
    out = []
    for name, build, n_match, probe, nomatch, cap_b in cases:
        out.append((
            name,
            torch.from_numpy(np.ascontiguousarray(build)).to(dev),
            torch.tensor(n_match, dtype=torch.int64, device=dev),
            torch.from_numpy(np.ascontiguousarray(probe)).to(dev),
            torch.from_numpy(np.ascontiguousarray(nomatch)).to(dev),
            cap_b,
        ))
    return out


def locate_sorted_bound(build, n_match, probe, nomatch) -> tuple:
    """(bound_ms, bound_by, bytes) of one sorted-probe call: every nomatch
    flag read and start/count written once, the probe key of live rows only
    (a nomatch row's key is never read), and min(n_match, live) keys of the
    sorted prefix (each live row needs a build key at its bound, and no key
    is needed twice: a prefix longer than the live rows is not read whole);
    against two binary searches of ceil(log2(n_match + 1)) compares per
    live row."""
    n = int(n_match)
    live = int((~nomatch).sum())
    nbytes = probe.shape[0] * (1 + 16) + live * 8 + min(n, live) * 8
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = live * 2 * max(1, (n + 1).bit_length()) / F32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), nbytes


def check_locate_sorted(dev, capture: dict, semi: dict, func: dict, tds: dict,
                        tdw: dict, arrays: dict, holistic: dict, temporal: dict,
                        statements: dict, lifecycle: dict, schedule: dict,
                        fte: dict, multihost: dict) -> dict:
    from trino_tpu_torch.ops import locate_sorted as ls

    if "inputs" not in capture:
        raise AssertionError("no sorted-probe launch was captured on the mesh path")
    if "largest" not in semi or "smallest" not in semi:
        raise AssertionError("no semi-join sorted-probe launch was captured")
    if "largest" not in func:
        raise AssertionError("no sorted-probe launch was captured in phase 5c")
    if "largest" not in tds:
        raise AssertionError("no sorted-probe launch was captured in phase 5d")
    if "largest" not in tdw:
        raise AssertionError("no sorted-probe launch was captured in phase 5e")
    if "largest" not in arrays:
        raise AssertionError("no sorted-probe launch was captured in phase 5g")
    if "largest" not in holistic:
        raise AssertionError("no sorted-probe launch was captured in phase 5i")
    if "largest" not in temporal:
        raise AssertionError("no sorted-probe launch was captured in phase 5j")
    if "largest" not in statements:
        raise AssertionError("no sorted-probe launch was captured in phase 5k")
    if "largest" not in lifecycle:
        raise AssertionError("no sorted-probe launch was captured in phase 5l")
    if "largest" not in schedule:
        raise AssertionError("no sorted-probe launch was captured in phase 5m")
    if "largest" not in fte:
        raise AssertionError("no spooled sorted-probe launch was captured in phase 5n")
    if "largest" not in multihost:
        raise AssertionError("no sorted-probe launch was captured on phase 5p's W = 2 mesh")
    build, n_match, probe, nomatch, cap_b = capture["inputs"]
    cases = [("main", build, n_match, probe, nomatch, cap_b)]
    cases += [("semi_largest",) + semi["largest"], ("semi_min_n_match",) + semi["smallest"]]
    cases += [(f"function_largest_{func['largest_query']}",) + func["largest"]]
    cases += [(f"tpcds_largest_{tds['largest_query']}",) + tds["largest"]]
    cases += [(f"tpcds_window_largest_{tdw['largest_query']}",) + tdw["largest"]]
    cases += [(f"arrays_largest_{arrays['largest_query']}",) + arrays["largest"]]
    cases += [(f"holistic_largest_{holistic['largest_query']}",) + holistic["largest"]]
    cases += [(f"temporal_largest_{temporal['largest_query']}",) + temporal["largest"]]
    cases += [(f"statements_largest_{statements['largest_query']}",) + statements["largest"]]
    cases += [(f"lifecycle_largest_{lifecycle['largest_query']}",) + lifecycle["largest"]]
    cases += [(f"schedule_largest_{schedule['largest_query']}",) + schedule["largest"]]
    cases += [(f"fte_largest_{fte['largest_query']}",) + fte["largest"]]
    cases += [(f"multihost_largest_{multihost['largest_query']}",) + multihost["largest"]]
    cases += probe_edge_inputs(dev)
    for name, b, nm, p, no, cb in cases:
        start, count = ls.locate_sorted(b, nm, p, no, cap_b=cb)
        torch.cuda.synchronize()
        rs, rc = ls.locate_sorted_reference(b, nm, p, no, cap_b=cb)
        if not (torch.equal(start, rs) and torch.equal(count, rc)):
            bad = int(((start != rs) | (count != rc)).sum())
            raise AssertionError(f"locate_sorted {name}: {bad} rows differ from the plain version")
        log(f"locate_sorted check {name}: P={p.shape[0]} build={b.shape[0]} "
            f"n_match={int(nm)} S={ls.launch_plan(max(cb, b.shape[0]), p.shape[0], 132)['s']} "
            f"matched_rows={int((count > 0).sum())} max_run={int(count.max())} bit-exact ok")

    main = time_probe_inputs("main", dev, capture["inputs"])
    semi_largest = time_probe_inputs("semi_largest", dev, semi["largest"])
    func_largest = time_probe_inputs("function_largest", dev, func["largest"])
    func_largest["query"] = func["largest_query"]
    tds_largest = time_probe_inputs("tpcds_largest", dev, tds["largest"])
    tds_largest["query"] = tds["largest_query"]
    arrays_largest = time_probe_inputs("arrays_largest", dev, arrays["largest"])
    arrays_largest["query"] = arrays["largest_query"]
    holistic_largest = time_probe_inputs("holistic_largest", dev, holistic["largest"])
    holistic_largest["query"] = holistic["largest_query"]
    temporal_largest = time_probe_inputs("temporal_largest", dev, temporal["largest"])
    temporal_largest["query"] = temporal["largest_query"]
    statements_largest = time_probe_inputs("statements_largest", dev, statements["largest"])
    statements_largest["query"] = statements["largest_query"]
    lifecycle_largest = time_probe_inputs("lifecycle_largest", dev, lifecycle["largest"])
    lifecycle_largest["query"] = lifecycle["largest_query"]
    schedule_largest = time_probe_inputs("schedule_largest", dev, schedule["largest"])
    schedule_largest["query"] = schedule["largest_query"]
    fte_largest = time_probe_inputs("fte_largest", dev, fte["largest"])
    fte_largest["query"] = fte["largest_query"]
    multihost_largest = time_probe_inputs("multihost_largest", dev, multihost["largest"])
    multihost_largest["query"] = multihost["largest_query"]
    keys = ("ms", "ms_l2_flushed", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {
        "name": "locate_sorted",
        "route": "cuda",
        "source": "trino_tpu_torch/csrc/locate_sorted.cu",
        "replaces": "trino_tpu/ops/pallas_probe.py:66",
        "max_abs_err": 0,
        **{k: main[k] for k in keys},
        "semi_join_inputs": semi_largest,
        "function_path_inputs": func_largest,
        "tpcds_inputs": tds_largest,
        "arrays_inputs": arrays_largest,
        "holistic_inputs": holistic_largest,
        "temporal_inputs": temporal_largest,
        "statements_inputs": statements_largest,
        "lifecycle_inputs": lifecycle_largest,
        "schedule_inputs": schedule_largest,
        "fte_inputs": fte_largest,
        "multihost_inputs": multihost_largest,
    }


def time_probe_inputs(name: str, dev, inputs) -> dict:
    """The kernel (back to back and L2-flushed), its plain version, the
    torch.searchsorted yardstick (first checked against the plain version)
    and the bound at one launch's inputs."""
    from trino_tpu_torch.ops import locate_sorted as ls

    build, n_match, probe, nomatch, cap_b = inputs
    prefix = build[: int(n_match)]
    probe64 = probe.to(torch.int64)

    def library():
        lo = torch.searchsorted(prefix, probe64, right=False)
        hi = torch.searchsorted(prefix, probe64, right=True)
        return torch.where(nomatch, 0, lo), torch.where(nomatch, 0, hi - lo)

    lib_start, lib_count = library()
    rs, rc = ls.locate_sorted_reference(build, n_match, probe, nomatch, cap_b=cap_b)
    if not (torch.equal(lib_start, rs) and torch.equal(lib_count, rc)):
        raise AssertionError(f"{name}: the searchsorted yardstick disagrees with the plain version")
    bound_ms, bound_by, nbytes = locate_sorted_bound(build, n_match, probe, nomatch)
    times = time_kernel(
        f"locate_sorted {name}",
        lambda: ls.locate_sorted(build, n_match, probe, nomatch, cap_b=cap_b),
        bound_ms,
    )
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = ls.launch_plan(max(cap_b, build.shape[0]), probe.shape[0], sms)
    out = {
        **times,
        "plain_ms": cuda_ms(
            lambda: ls.locate_sorted_reference(build, n_match, probe, nomatch, cap_b=cap_b)
        ),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": cuda_ms(library),
        "bytes": nbytes,
        "p": probe.shape[0],
        "live": int((~nomatch).sum()),
        "build": build.shape[0],
        "n_match": int(n_match),
        "s": plan["s"],
    }
    log(f"locate_sorted {name}: {out} plan={plan} "
        f"(library: torch.searchsorted lower+upper, masked)")
    return out


def main() -> int:
    import shutil

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    if os.environ.get("PYTHONHASHSEED") != "0":
        # the TPC-H comment pools follow Python's string hash: run again
        # under a fixed seed, so the other processes see the same words
        os.execve(sys.executable, [sys.executable, os.path.abspath(__file__)] + sys.argv[1:],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    if not os.path.isdir(os.path.join(here, "trino_tpu_torch")):
        raise SystemExit("chip_smoke: the trino_tpu_torch package is not beside the script")
    # the CPU reference processes run beside every card phase, on their own cores
    procs, reference_path = start_references(here)
    children = list(procs.values())
    try:
        return drive(here, procs, reference_path, children)
    finally:
        for proc in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(os.path.dirname(reference_path), ignore_errors=True)


def drive(here: str, procs: dict, reference_path: str, children: list) -> int:
    from trino_tpu_torch.device import resolve_device
    from trino_tpu_torch.kernels import build

    dev = resolve_device()
    log(f"card process: {_pin_to_cores(upper=False)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    kernels = ["grouped_sums", "locate_sorted"]
    t0 = time.perf_counter()
    build.build_all(kernels)
    log(f"build: {', '.join(kernels)} in {time.perf_counter() - t0:.1f} s")
    for name in kernels:
        log(build.log_path(name).read_text().strip())
    check_ptxas(kernels)

    seconds = {"build": time.perf_counter() - t0}
    # phases 5d and 5e run in a second card process, beside phases 3-5l
    card, card_path = start_tpcds_card(here, reference_path)
    children.append(card)

    def tpcds_reference(phase: str) -> dict:
        return wait_reference(procs, reference_path, phase)

    budgets_path = reference_path + ".budgets"

    def timed(phase: str, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[phase] = time.perf_counter() - t
        return out

    k1 = timed("3", check_grouped_sums, dev)
    main_path = timed("4", run_main_path)
    k1["launches"] = main_path["launches"]
    capture: dict = {}
    mesh_path = timed("5", run_mesh_path, capture)
    semi: dict = {}
    semi_path = timed("5b", run_semi_cross_path, semi)
    func: dict = {}
    func_path = timed("5c", run_function_path, func)
    mem_path = timed("5f", run_memory_path, tpcds_reference, budgets_path)
    arrays: dict = {}
    arrays_k1: dict = {}
    arr_path = timed("5g", run_array_path, tpcds_reference, arrays, arrays_k1)
    agg_path = timed("5h", run_aggregate_path, tpcds_reference)
    holistic: dict = {}
    hol_path = timed("5i", run_holistic_path, tpcds_reference, holistic)
    temporal_k1: dict = {}
    temporal: dict = {}
    tem_path = timed("5j", run_temporal_path, tpcds_reference, temporal_k1, temporal)
    statements_k1: dict = {}
    statements: dict = {}
    stm_path = timed("5k", run_statement_path, tpcds_reference, statements_k1, statements)
    lifecycle_k1: dict = {}
    lifecycle: dict = {}
    lc_path = timed("5l", run_lifecycle_path, tpcds_reference, lifecycle_k1, lifecycle)
    schedule: dict = {}
    sch_path = timed("5m", run_schedule_layout_path, tpcds_reference, schedule)
    fte: dict = {}
    fte_path = timed("5n", run_fte_observatory_path, fte)
    srv_path = timed("5o", run_serving_path)
    multihost_probe: dict = {}
    multihost_k1: dict = {}
    mh_path = timed("5p", run_multihost_path, multihost_probe, multihost_k1)
    pw_path = timed("5q", run_prewarm_path, here, children, smi)
    tpcds = timed("5d-5e wait", wait_tpcds_card, card, card_path, procs, dev)
    for phase in ("5d", "5e"):  # the second card process's seconds
        seconds[phase] = tpcds[phase]["seconds"]
    tds_path, tds = tpcds["5d"]["path"], tpcds["5d"]["record"]
    tdw_path, tdw = tpcds["5e"]["path"], tpcds["5e"]["record"]

    def check_tpch_paths():
        cpu = tpcds_reference("tpch")
        for path in (main_path, mesh_path, semi_path, func_path, sch_path, fte_path,
                     srv_path, pw_path):
            path.pop("check")(cpu)
        mh_path.pop("check")({**cpu, **tpcds_reference("5p")})

    timed("4-5c checks", check_tpch_paths)
    k1["launches"] += (
        arr_path["k1_launches"] + agg_path["k1_launches"] + hol_path["k1_launches"]
        + tem_path["k1_launches"] + stm_path["k1_launches"] + lc_path["k1_launches"]
        + sch_path["k1_launches"] + fte_path["k1_launches"] + srv_path["k1_launches"]
        + mh_path["k1_launches"] + pw_path["k1_launches"]
    )
    k1["launches_by_path"] = {
        "q1_double": main_path["launches"], "arrays": arr_path["k1_launches"],
        "aggregates": agg_path["k1_launches"], "holistic": hol_path["k1_launches"],
        "temporal": tem_path["k1_launches"], "statements": stm_path["k1_launches"],
        "lifecycle": lc_path["k1_launches"], "schedule_layouts": sch_path["k1_launches"],
        "fte_observatory": fte_path["k1_launches"], "serving": srv_path["k1_launches"],
        "multihost": mh_path["k1_launches"], "prewarm": pw_path["k1_launches"],
    }
    k1["arrays_inputs"] = timed("6a", check_grouped_sums_captured, dev, arrays_k1)
    k1["temporal_inputs"] = check_grouped_sums_captured(dev, temporal_k1, "temporal")
    k1["statements_inputs"] = check_grouped_sums_captured(dev, statements_k1, "statements")
    k1["lifecycle_inputs"] = check_grouped_sums_captured(dev, lifecycle_k1, "lifecycle")
    k1["multihost_inputs"] = check_grouped_sums_captured(dev, multihost_k1, "multihost")
    k2 = timed("6", check_locate_sorted, dev, capture, semi, func, tds, tdw, arrays,
               holistic, temporal, statements, lifecycle, schedule, fte, multihost_probe)
    log(f"phase seconds: {json.dumps(seconds)}")
    k2["launches"] = (
        mesh_path["launches"] + semi_path["launches"] + func_path["launches"]
        + tds_path["launches"] + tdw_path["launches"] + mem_path["launches"]
        + arr_path["k2_launches"] + agg_path["k2_launches"] + hol_path["k2_launches"]
        + tem_path["k2_launches"] + stm_path["k2_launches"] + lc_path["k2_launches"]
        + sch_path["k2_launches"] + fte_path["k2_launches"] + srv_path["k2_launches"]
        + mh_path["k2_launches"] + pw_path["k2_launches"]
    )
    k2["launches_by_path"] = {
        "q3_mesh": mesh_path["launches"], "semi_cross": semi_path["launches"],
        "semi_cross_from_semi_joins": semi["semi_path"],
        "functions_distinct": func_path["launches"],
        "functions_distinct_per_mesh_query": func_path["per_query"],
        "tpcds": tds_path["launches"],
        "tpcds_per_mesh_query": tds_path["per_query"],
        "tpcds_window": tdw_path["launches"],
        "tpcds_window_per_mesh_query": tdw_path["per_query"],
        "memory": mem_path["launches"],
        "arrays": arr_path["k2_launches"],
        "aggregates": agg_path["k2_launches"],
        "holistic": hol_path["k2_launches"],
        "temporal": tem_path["k2_launches"],
        "statements": stm_path["k2_launches"],
        "lifecycle": lc_path["k2_launches"],
        "schedule_layouts": sch_path["k2_launches"],
        "fte_observatory": fte_path["k2_launches"],
        "serving": srv_path["k2_launches"],
        "multihost": mh_path["k2_launches"],
        "prewarm": pw_path["k2_launches"],
    }
    log(json.dumps({"kernels": [k1, k2], "not_ported": []}))
    log(smi)
    log(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cpu-reference"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(cpu_reference(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--tpcds-card"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(tpcds_card_process(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--prewarm-card"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(prewarm_card_process(*sys.argv[2:6]))
    sys.exit(main())
