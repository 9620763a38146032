#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA engine (`siddhi_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a host with one CUDA card, `nvcc` (PATH or
/usr/local/cuda) and the PyTorch build for CUDA. It exits non-zero on any
failure, and before printing any result when there is no CUDA device or no
engine next to it. Phases, each printed as it ends:
  1. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
     build of every kernel in siddhi_tpu_torch/csrc/ (one nvcc per source);
  2. each kernel against its plain PyTorch version on the card, at the main
     path's shapes (B=32768, W=50; the fused path's K=8 and K=32 chunks for
     the wire decode and the deliver pack) and ragged ones, from the same
     inputs and state; times from CUDA events;
     The group-by kernels (lengthBatch step, slot assignment, keyed running
     sum, keep-last) the same way at the tumbling_groupby path's shapes
     (B=32768, lengthBatch(1024), 33,826 flow rows, G=1024), ragged ones,
     1,000 distinct keys and 2,000 (overflow); the join slice's kernels
     (sliding time-window step, ring view, join probe compaction) at paths
     J, T and T2's shapes and ragged ones (see join_kernel_phase); the
     pattern slice's (slot pass, count pass, completions) at paths P and C's
     shapes, out of lanes, overflowing and ragged (see pattern_kernel_phase);
     the per-event scan K16 at paths L and A's shapes (and a one-row TIMER
     step), every slot kind of tests/test_torch_pattern_scan.py, T=33 with
     ragged B, lanes exhausted, an overflowing buffer and condition programs
     with nulls and int/float promotion (see pattern_scan_kernel_phase);
     the time-batch step K17, the running and keyed running extremes K18
     and K19, K3's key lane and the distinct count K20 at paths TB's and
     XB's shapes, bit for bit (see time_batch_kernel_phase); the table's
     insert K21, sorted index and probe K22, condition match K23 and
     sequential update / update-or-insert K24 at the table paths' shapes,
     ragged ones, with nulls, a full table, repeated keys, a rekey conflict
     and a table holding duplicates of an indexed key, bit for bit (see
     table_kernel_phase); the special windows' steps K25-K28 (sort,
     frequent, lossyFrequent, cron) at paths SW, FQ, LF and CR's shapes,
     ragged B, NaN/-0.0/null sort keys, ties, the arrival evicted, a full
     frequent table, prunes, a full lossy key table, TIMER rows anywhere and
     buckets past their slots, bit for bit (see special_window_kernel_phase);
     the partitioned length-window step K29 and the windowed min/max of a
     partition K30 at path PT's shape (B=32768, P=1024, W=50) and ragged,
     trap and inner-stream batches, bit for bit (see partition_kernel_phase);
     the partitioned time window K31 at path PTE's shape (B=32768, P=1024,
     W=1024) and a TIMER step over every slot, the partitioned batch
     window K32 at path PTB's shape and at a lengthBatch(64) over P=1024,
     idle timeouts, and the per-partition group-slot assignment K33 with a
     partition overflowing, ragged shapes among them, bit for bit (see
     partition_windows_kernel_phase); the keyed pattern kernels K34-K37
     (slot pass, count pass, completions, per-event scan), the chunk lists
     and the placement at paths PPF, PPC and PPA's shapes (P=1024,
     T=128), a TIMER step over 1,024 slots, ragged B/P/T, chunks across a
     slot's rows, fork and emission overflow in one slot, fresh slots,
     two streams on one key table, bit for bit (see
     partition_pattern_kernel_phase); the join slice's keyed ring view K38
     and probe compaction K39 at path PJ's shape (P=1024, W=50, 32,768
     probe rows, joinCapacity 512 a slot) with inner and outer joins,
     EXPIRED probes, a unidirectional side, a self-join, one slot
     overflowing, empty slots and keys past capacity, ragged B/P/W (K38,
     one launch a view, also at W 32/33/64/65/1,024/1,025, empty and holed
     rings, 40 lanes and W past shared memory, timed three ways beside a
     stable argsort and argsort plus a gather a lane), and
     the keyed sort and frequent windows K40/K41 at paths PSW's and PFQ's
     shapes with NaN/-0.0 sort keys, -0.0/0.0 frequent keys and more than
     N new keys a call in one slot, bit for bit (see
     partition_join_kernel_phase); the keyed lossyFrequent and cron
     windows K42/K43 at paths PLF's and PCR's shapes (P=1024; 400 key slots
     a partition; a one-second bucket, then a TIMER step over every slot),
     ragged, a full key table, key tables in global scratch and TIMER rows
     anywhere, bit for bit (see partition_special_kernel_phase); the
     aggregation's duration-chain step K44 at path AGG's shape (B=32768,
     G=1024, sec ... year) and ragged B and G, across month, leap-day and
     year ends, a fifth close a step, a store overflowing and NaN prices,
     and its find merge K45 for every `per`, bit for bit (see
     aggregation_kernel_phase); order-by/limit K46, flat and per
     partition, at path NW's shapes and ragged with the encoding's edge
     keys, and the composite-key mix K47 over 2-8 columns, exactly (see
     named_window_kernel_phase); the ring's seq view K48 on path LIN's J
     ring, a time ring with holes, W 1/50/1,024 and an empty ring, and the
     view paired with it, exactly (see lineage_kernel_phase); the sharded
     execution's owner hash and fold K49 and routed pre-pass K50 at path
     SH's shapes and ragged (B 1/33/32,768, D 1/2/8, INT64 edge keys, NaN
     and -0.0 lanes, all-TIMER batches), exactly, the fold (one launch
     reading each shard's lanes in place) also at D 64 and 70 (a device
     pointer table) and timed three ways beside a `torch.gather` a lane
     and the stacks it replaced (see shard_kernel_phase);
     the ring view K11 (one launch a view) and its seq lane K48 at W 1, 16,
     100, 1,024 and 57,345, full, rotated, with holes and empty, and the
     row lists of K31/K32/K37 (one stable sort by slot) at B 1/33/2,048/
     2,049/32,768 and P 1/33/1,024 with all-TIMER, no-TIMER and all-invalid
     batches, exactly, each timed three ways beside its stock calls (see
     ring_view_kernel_phase, row_lists_kernel_phase); K21-K23 on float32
     keys with subnormals and K23/K24 with float arithmetic in their table
     programs, exactly (see subnormal_kernel_phase); subnormal operands and
     keys run through the trap data of K16, K22 and K25-K43, the
     arithmetic traps (ARITH_TRAPS: subnormals, FLT_MIN's neighbours, sums
     cancelling below it) through K2, K3, K8, K16, K17-K19, K29/K30 and
     K44, and K2's and K8's sums of EXACT_SUM_VALUES equal their plain
     versions' exactly;
  3. verify cases filter_num, len_window_avg, len_window_minmax,
     len_batch_group, having_order, stddev_distinct, time_window,
     external_time, self_join, pattern_within, count_seq,
     logical_pattern (the per-event scan), sort_window, frequent and
     stream_fn on the card against the frozen CPU rows of VERIFY.json,
     table_crud and partitioned by their store query, and multi_query_shared (four queries
     on one stream, one rate-limited) per query against device="cpu";
  4. the main path at full width: BASELINE.json config 1 (filter + length(50)
     window + avg) and the same app with min/max added, at @app:batch 32768,
     2,000,000 events each through send_columns in calls of 8 batches (the
     first of 4), which take the fused ingest path (K=8 chunks; K=4 first);
     every kernel of the path must have launched (counts set to 0 just
     before, read just after), the first batch's rows must match the same
     run on device="cpu", and the first 20 batches' rows must match the
     per-batch form (fused engines detached), whose events/s is printed
     beside the fused form's;
  5. the tumbling_groupby path (BASELINE.json config 2: lengthBatch(1024)
     group by symbol with sum and avg) at the same width and in the same
     way, with its own launch counts; then the same app with 1,000 distinct
     symbols for 4 batches against device="cpu";
  6. path J, sliding_join (BASELINE.json config 3: a length(100) self-join
     on volume, @app:batch 8192, joinCapacity 8192), 2,000,000 events fused
     and a 20-batch per-batch prefix, in the same way; path T, the same
     self-join over time(1 sec) windows under @app:playback (joinCapacity
     16384), 16,384 events in batches of 8192 with the TIMER steps the
     event-time clock sends; path T2, a time(1 sec) window with
     avg/min/max at batch 32768 under @app:playback, 4 batches. Each
     path's own launch counts,
     no join overflow, the first 4 batches (T, T2: 2) against device="cpu";
  7. path P, pattern_2state (BASELINE.json config 4: every a1[price > 95] ->
     a2[price < 5] within 1 sec, patternCapacity 4096, chunks of 2048) with
     2,000,000 events, and path C, count_sequence (config 5: every
     a1[price > 90]<2:4> -> a2[price < 10], patternCapacity 512,
     patternChunk 8192) with 1,000,000, both at @app:batch 32768, fused in
     calls of 8 batches and a 20-batch per-batch prefix, as above; each
     kernel's launches held to its launches per step times the steps, no
     pattern overflow, and the device busy share of one more fused call;
  8. the per-event scan (patternCapacity 1024, B=32768, seed 7): path L,
     every (e1[price > 95] and e2[volume > 990]) -> e3[symbol == e1.symbol
     and price < e1.price - 90] within 1 sec, 1,000,000 events fused in calls
     of 8 batches and a 20-batch per-batch prefix (exactly equal); path A,
     every e1[price > 95] -> not [symbol == e1.symbol and price < 5] for
     100 milliseconds under @app:playback, 16 batches one per call with the
     TIMER steps the clock sends; K16 launches = steps (L) and = data +
     TIMER steps (A), no pattern overflow, each against device="cpu" on
     its first 8,192 events;
  9. the tumbling time windows (see tb_path_phase and xb_path_phase): path
     TB, timeBatch(1 sec) group by symbol with avg, stdDev, min, max,
     maxForever, distinctCount and count under @app:playback, 4 batches'
     events one 1,000-event bucket a call with its TIMER step; path XB,
     externalTimeBatch(ets, 1 sec) with avg, stdDev, max, minForever,
     distinctCount and count, 1,000,000 events fused and a 20-batch
     per-batch prefix (exactly equal); each path's launches, no overflow,
     and its first 8,192 events against device="cpu" at @app:batch 4096;
 10. the table paths (bench.py:266's traffic, B=8192, 32 batches fused in
     calls of 8; see table_path_phase): TAB-PK (a @PrimaryKey update of a
     1,000,000-row table down the indexed path), TAB-IX (the same update
     without @PrimaryKey: the auto-index's duplicate flag picks the
     indexed or dense path on the device), TAB-DENSE (a range update
     and a delete over 100,000 rows), TAB-UPSERT (update or insert into a
     100,000-row table that fills) and TAB-JOIN (a stream-table join and an
     `in` condition over 16,384 rows); each path's launches held to its
     steps, its table after 10 batches equal to the per-batch form's, its
     first batch equal to device="cpu", events/s and the device busy
     share of one more fused call;
 11. the special-window, stream-function and rate-limit paths at @app:batch
     32768 (SPECIAL_APPS): SW (sort(100, price desc, volume asc), 1,000,000
     events), FQ (frequent(100, symbol) over Zipf symbols) and LF
     (lossyFrequent(0.01, 0.001, symbol), 4,000 key slots) fused in calls of
     8 batches with a 20-batch per-batch prefix (exactly equal), launches =
     steps; CR (cron every second, group by, @app:playback, 16 one-second
     buckets a call each, launches = data + TIMER steps); FN (#pol2Cart, a
     filter on the added x, `output last every 4096 events`, per batch);
     each without overflow and its first 8,192 events against
     device="cpu";
 12. path PT (PT_APP; see partition_path_phase): a length(50) window per
     key into an #inner stream and a filter on it, 1,000 keys in a
     1,024-slot key table, 1,000,000 events per batch; launches held to
     the steps, events/s, the device busy share, the first 4 batches
     against device="cpu", and capacity 512 overflowing against
     device="cpu"; then the time and batch windows inside a partition
     (PTW_APPS; see partition_windows_path_phase): PTE (externalTime(ets,
     60 sec) per symbol, 1,000,000 events per batch), PTB (a range
     partition of three price bands, timeBatch(1 sec) group by symbol under
     @app:playback, one bucket a call with its TIMER step) and PTT (PTE on
     time(1 sec) under @app:playback, 4,096 events with every TIMER step
     reaching every partition); launches held to the steps, events/s, the
     busy share (PTE) and each path's first call against device="cpu";
     then patterns inside a partition (PP_PATTERNS; see
     partition_pattern_path_phase): PPF (the partitioned pattern_2state on
     the fast route, K34/K36), PPC (a count <2:4>, K35/K36), 1,000,000
     events per batch each, and PPA (an absent pattern under
     @app:playback, K37, PPA_BATCHES calls of one batch with a TIMER step
     per deadline over every slot); launches held to the steps,
     events/s, the busy share and each path's first events against
     device="cpu"; then joins and the sort and frequent windows inside a
     partition (PJ_APPS; see partition_join_path_phase): PJ (a per-symbol
     equality join of Trades and Quotes over length(50) windows, one batch
     a stream a call, 32 steps), PSW (a per-symbol sort(10) price book,
     262,144 events) and PFQ (per-symbol frequent(10, volume), 262,144
     events); launches held to the steps, events/s, the busy share and
     each path's first call against device="cpu"; then the lossyFrequent
     and cron windows inside a partition (PSP_APPS; see
     partition_special_path_phase): PLF (per-symbol lossyFrequent(0.1,
     0.01, volume), 131,072 events) and PCR (per-symbol cron every second
     with sum(volume) group by, @app:playback, 16 one-second calls each
     with its TIMER step over every slot), each against device="cpu";
 13. the incremental aggregation (agg_app; see aggregation_path_phase):
     AGG, sec ... year over 1,000 symbols at @app:aggGroupCapacity 1024, 4
     batches of 32,768 events (1.024 s of event time each), K44 once a
     step, then two store queries timed (per 'sec'; within .. per 'min'),
     and AGJ, 8 calls of 1,024 probes joining it `within .. per 'sec'` (a
     K45 and a K12 a step); the first batch's stores, tables and queries
     and the first probe call against device="cpu";
 14. path NW (nw_app; see named_window_path_phase): 1,000 symbols x 4
     venues of trades into a shared length(32,768) named window, its
     emissions grouped into VenueAvg, a `define trigger Tick at every 1 sec`
     under @app:playback joining the whole window into a top-10 Board
     (`order by v desc, venue limit 10`, K46), a per-venue top 3 inside a
     partition (K46's partition entry), a store query over the window
     after each 1,024-event call; events/s, trigger steps a call, ms a
     trigger step, the busy share, and every delivered row and store query
     of the first calls against device="cpu";
 15. path LIN (see lineage_path_phase): @app:lineage(capacity='262144') on
     the quickstart (its stream with @flightRecorder(size='1024')), J and P
     at @app:batch 32,768, a 2-batch call then a 262,144-event call, fused,
     lineage on and off (and J in sample mode): rows equal on and off, the
     recorder's counts, the first call's records and resolutions against
     device="cpu", K48 launches = join probe steps, the flight ring; events/s
     on and off, and the arena's per-batch D2H.
 16. path SH (see shard_path_phase): `@app:shard` with `mesh_devices` giving
     8 shards, all on the one card (XLA_FLAGS' host device count 8), B
     32,768, 1,000 symbols: SH-PART (PT's app, axis 'part') and SH-KEYS (a
     count/max/sum group-by, axis 'keys', K49) against the app with
     sharding off, SH-ROUTED (PT's window query as the routed step, K50)
     against the unsharded step, SH-BATCH (a filter, axis 'batch', fused
     calls of 8 batches) against sharding off; events/s sharded and off.
 17. path SUB (SUB_APPS; see subnormal_path_phase): float32 subnormals,
     one event a send, through filters, table keys, updates and `in`, sort
     windows, patterns on both routes, a join `on`, distinctCount and
     partitions, and through float32 arithmetic (filters, projections,
     sums, averages, stdDev, min/max, grouped and partitioned, a table's
     set clause, a pattern condition), every row against device="cpu",
     each app's kernel launched.
Each phase prints an `elapsed ... s after ...` line.
The line before the last is the JSON kernel table; the last line is
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --kernels

stops after phase 2 (each kernel against its plain version, and its times).

    python3 chip_smoke.py --partition

builds the kernels and runs only the partition slices: K29-K43 against
their plain versions, and paths PT, PTE, PTB, PTT, PPF, PPC, PPA, PJ, PSW,
PFQ, PLF and PCR;
`--partition-kernels` stops after K29-K43, `--partition-patterns` runs
only K34-K37 and paths PPF, PPC and PPA (`--no-paths`: only K34-K37), and
`--partition-joins` only K38-K41 and paths PJ, PSW and PFQ (`--no-paths`:
only K38-K41).

    python3 chip_smoke.py --aggregation

builds the kernels and runs only K44 and K45 against their plain versions
and paths AGG and AGJ (`--no-paths`: only K44 and K45).

    python3 chip_smoke.py --named-windows

builds the kernels and runs only K46 and K47 against their plain versions
and path NW (`--no-paths`: only K46 and K47).

    python3 chip_smoke.py --lineage

builds the kernels and runs only K48 against its plain version and path LIN
(`--no-paths`: only K48).

    python3 chip_smoke.py --shard

builds the kernels and runs only K49 and K50 against their plain versions
and path SH (`--no-paths`: only K49 and K50).

    python3 chip_smoke.py --sorts

builds the kernels and runs only the checks and times of the two kernels
on `csrc/radix_sort.cuh`'s sort, K46 (with K47, which shares its phase)
and K22 (the index build and the probe), and writes their figures to
chiprun_out/sorts.json.

    python3 chip_smoke.py --redesign

builds the kernels and runs only the K11/K48 and row-list checks and their
three-way times, the subnormal table checks and path SUB (`--no-paths`:
the kernels only), and writes their figures to chiprun_out/redesign.json.

    python3 chip_smoke.py --profile

instead builds the kernels and prints where the time goes on the quickstart
min/max app, tumbling_groupby, sliding_join, pattern_2state, count_sequence,
path L's logical pattern and path XB: for one per-batch batch and
for one fused K=8 chunk, the host stages timed around
torch.cuda.synchronize(), and device time by kernel from torch.profiler over
4 batches / 4 chunks; and on paths T, A and TB, each call's split into its
data steps and its TIMER steps, with the device busy share of one call.
"""

from __future__ import annotations

import collections
import itertools
import json
import logging
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
RTOL = 2e-4  # bench.py:_rows_match
# float32 subnormals of both signs: XLA's comparisons, sorts and searches
# take them as zeros, and so do the port's (core/types.py flush_subnormal)
SUBNORMALS = np.array([1e-40, -1e-40, 1e-38, -1e-38, 2e-45, -2e-45], np.float32)
# float32 operands for arithmetic traps: the subnormals (read as zeros),
# the zeros, FLT_MIN's neighbours and values whose sums and differences
# cancel below FLT_MIN (flushed as zeros)
ARITH_TRAPS = np.concatenate([SUBNORMALS, np.array(
    [0.0, -0.0, 1.1754944e-38, -1.1754944e-38, 1.5e-38, -1.4e-38, 2e-38, 1e-20], np.float32)])
# sums of these are exact in any order once a subnormal reads as zero, so a
# kernel's sums equal its plain version's bit for bit
EXACT_SUM_VALUES = np.concatenate([SUBNORMALS, np.array([0.0, -0.0, 1.0, -1.0, 2.0, 3.5],
                                                        np.float32)])


def arith_traps(rng, x: np.ndarray, share: float = 0.1) -> np.ndarray:
    """x (float32) with a `share` of its values drawn from ARITH_TRAPS."""
    pick = rng.random(x.shape) < share
    x = x.copy()
    x[pick] = rng.choice(ARITH_TRAPS, int(pick.sum()))
    return x
MAIN_BATCH, MAIN_W, MAIN_EVENTS = 32768, 50, 2_000_000

# the 8-symbol stock feed of bench.py:_make_stock_data
SYMBOLS = ["WSO2", "IBM", "GOOG", "MSFT", "ORCL", "AAPL", "AMZN", "NVDA"]

MAIN_APP = """
@app:batch(size='{batch}')
define stream StockStream (symbol string, price float, volume long);
@info(name='q')
from StockStream[price > 50]#window.length({w})
select symbol, avg(price) as ap{extra}
insert into Out;
"""
MINMAX = ", min(price) as mn, max(price) as mx"
GROUP_N, GROUP_G = 1024, 1024  # lengthBatch(1024); the default group capacity
GROUP_APP = """
@app:batch(size='{batch}')
define stream StockStream (symbol string, price float, volume long);
@info(name='q')
from StockStream#window.lengthBatch({n})
select symbol, sum(volume) as total, avg(price) as ap
group by symbol
insert into Out;
"""

# slice 4: joins (bench.py sliding_join, BASELINE.json config 3) and time windows
JOIN_BATCH, JOIN_W, JOIN_CAP, TIME_JOIN_CAP, TIME_W = 8192, 100, 8192, 16384, 1024
# T and T2 run 16,384 events and 4 batches (250,000 and 16 until the
# partitioned patterns' paths joined the script's time, 65,536 and 8 until
# the partitioned joins' did, 32,768 until the aggregation's did)
JOIN_EVENTS, TIME_JOIN_EVENTS, TIME_AGG_BATCHES = 2_000_000, 16_384, 4
JOIN_APP = """
@app:joinCapacity(size='{cap}')
@app:batch(size='{batch}')
{playback}define stream StockStream (symbol string, price float, volume long);
@info(name='q')
from StockStream#window.{win} as a join StockStream#window.{win} as b
on a.volume == b.volume
select a.symbol as s1, b.symbol as s2
insert into Out;
"""
SLIDING_JOIN_APP = JOIN_APP.format(cap=JOIN_CAP, batch=JOIN_BATCH, playback="",
                                   win=f"length({JOIN_W})")
TIME_JOIN_APP = JOIN_APP.format(cap=TIME_JOIN_CAP, batch=JOIN_BATCH, playback="@app:playback\n",
                                win="time(1 sec)")
TIME_AGG_APP = """
@app:playback @app:batch(size='32768')
define stream StockStream (symbol string, price float, volume long);
@info(name='q')
from StockStream[price > 50]#window.time(1 sec)
select symbol, avg(price) as ap, min(price) as mn, max(price) as mx
insert into Out;
"""

# patterns (bench.py pattern_2state and count_sequence, BASELINE.json
# configs 4 and 5), with their engine-buffer annotations as bench.py sets them
PATTERN_EVENTS, COUNT_EVENTS = 2_000_000, 1_000_000
PATTERN_T, PATTERN_C = 4096, 2048  # token table, chunk (T // 2)
COUNT_T, COUNT_C, COUNT_K = 512, 8192, 4  # token table, @app:patternChunk, <2:4>
PATTERN_APP = """
@app:patternCapacity(size='4096')
@app:batch(size='{batch}')
define stream StockStream (symbol string, price float, volume long);
@info(name='q')
from every a1=StockStream[price > 95] -> a2=StockStream[price < 5]
within 1 sec
select a1.symbol as s1, a2.symbol as s2
insert into Out;
"""
COUNT_APP = """
@app:patternCapacity(size='512')
@app:patternChunk(size='8192')
@app:batch(size='{batch}')
define stream StockStream (symbol string, price float, volume long);
@info(name='q')
from every a1=StockStream[price > 90]<2:4> -> a2=StockStream[price < 10]
select a2.symbol as s2
insert into Out;
"""

# the per-event scan route (path L, logical then cross-ref; path A,
# absence under playback), each with patternCapacity 1024
# SCAN_CPU_EVENTS: the events each of L, A, TB, SW-FN checks against device="cpu"
SCAN_T, LOGICAL_EVENTS, ABSENT_BATCHES, SCAN_CPU_EVENTS = 1024, 1_000_000, 16, 4096
LOGICAL_APP = """
@app:patternCapacity(size='1024')
@app:batch(size='{batch}')
define stream StockStream (symbol string, price float, volume long);
@info(name='q')
from every (e1=StockStream[price > 95] and e2=StockStream[volume > 990]) ->
    e3=StockStream[symbol == e1.symbol and price < e1.price - 90] within 1 sec
select e1.symbol as s, e1.price as p1, e2.volume as v2, e3.price as p3
insert into Out;
"""
ABSENT_APP = """
@app:playback
@app:patternCapacity(size='1024')
@app:batch(size='{batch}')
define stream StockStream (symbol string, price float, volume long);
@info(name='q')
from every e1=StockStream[price > 95] ->
    not StockStream[symbol == e1.symbol and price < 5] for 100 milliseconds
select e1.symbol as s, e1.price as p
insert into Out;
"""

VERIFY_HEAD = (
    "@app:batch(size='32')\n"
    "define stream S (symbol string, price float, volume long);\n"
)
VERIFY_CASES = {
    "filter_num": VERIFY_HEAD + "@info(name='q') from S[price > 50 and volume < 800] select symbol, price insert into Out;",
    "len_window_avg": VERIFY_HEAD + "@info(name='q') from S#window.length(7) select symbol, avg(price) as ap, sum(volume) as tv insert into Out;",
    "len_window_minmax": VERIFY_HEAD + "@info(name='q') from S#window.length(5) select min(price) as mn, max(price) as mx insert into Out;",
    "len_batch_group": VERIFY_HEAD + "@info(name='q') from S#window.lengthBatch(8) select symbol, sum(volume) as tv, count() as c group by symbol insert into Out;",
    "having_order": VERIFY_HEAD + "@info(name='q') from S#window.lengthBatch(8) select symbol, sum(volume) as tv group by symbol having tv > 100 order by tv desc limit 3 insert into Out;",
    "stddev_distinct": VERIFY_HEAD + "@info(name='q') from S#window.length(9) select stdDev(price) as sd, distinctCount(symbol) as dc insert into Out;",
    "time_window": "@app:playback\n" + VERIFY_HEAD + "@info(name='q') from S#window.time(40) select symbol, sum(volume) as tv insert into Out;",
    "external_time": VERIFY_HEAD + "@info(name='q') from S#window.externalTime(volume, 500) select symbol, count() as c insert into Out;",
    "self_join": VERIFY_HEAD + """@app:joinCapacity(size='256')
        @info(name='q') from S#window.length(4) as a join S#window.length(4) as b
        on a.volume == b.volume select a.symbol as s1, b.symbol as s2 insert into Out;""",
    "pattern_within": VERIFY_HEAD + """@app:patternCapacity(size='64')
        @info(name='q') from every a=S[price > 90] -> b=S[price < 10] within 100 milliseconds
        select a.symbol as s1, b.symbol as s2 insert into Out;""",
    "count_seq": VERIFY_HEAD + """@app:patternCapacity(size='64')
        @info(name='q') from every a=S[price > 80]<2:3> -> b=S[price < 20]
        select b.symbol as s2 insert into Out;""",
    # the per-event scan route
    "logical_pattern": VERIFY_HEAD + """@app:patternCapacity(size='64')
        @info(name='q') from every (a=S[price > 90] and b=S[volume > 500])
        select a.price as pa, b.volume as vb insert into Out;""",
    # the special windows and a stream function
    "sort_window": VERIFY_HEAD + "@info(name='q') from S#window.sort(5, price) select min(price) as mn, count() as c insert into Out;",
    "frequent": VERIFY_HEAD + "@info(name='q') from S#window.frequent(3, symbol) select symbol, count() as c insert into Out;",
    "stream_fn": VERIFY_HEAD + "@info(name='q') from S#log('v') select symbol, price insert into Out;",
}
# bench.py's multi_query_shared: no frozen rows; held per query against device="cpu"
MULTI_QUERY_CASE = VERIFY_HEAD + """@info(name='q') from S[price > 40]#window.length(6) select symbol, avg(price) as ap insert into Out1;
        @info(name='q2') from S[price > 40]#window.length(6) select symbol, max(price) as mx insert into Out2;
        @info(name='q3') from S#window.lengthBatch(8) select sum(volume) as tv insert into Out3;
        @info(name='q4') from S[volume > 300] select symbol, volume output every 5 events insert into Out4;"""


# bench.py:VERIFY_TABLE_CASES: read back by a store query
VERIFY_TABLE_CASES = {
    "table_crud": (
        VERIFY_HEAD + """@capacity(size='512') define table T (symbol string, total long);
        @info(name='w') from S#window.lengthBatch(8)
        select symbol, sum(volume) as total group by symbol
        update or insert into T on T.symbol == symbol;""",
        "from T select symbol, total",
    ),
    "partitioned": (
        VERIFY_HEAD + """@app:partitionCapacity(size='16')
        @capacity(size='2048') define table T (symbol string, ap float);
        partition with (symbol of S) begin
        @info(name='w') from S[price > 20] select symbol, price as ap
        insert into T;
        end;""",
        "from T select symbol, ap",
    ),
}

# path PT: the Siddhi partition idiom, a per-key length window feeding an
# inner stream (see partition_path_phase)
PT_APP = """@app:batch(size='{batch}') @app:partitionCapacity(size='{cap}')
define stream StockStream (symbol string, price float, volume long);
partition with (symbol of StockStream) begin
  @info(name='pw') from StockStream#window.length({w})
    select symbol, avg(price) as ap, max(price) as mx, count() as n insert into #A;
  @info(name='q') from #A[ap > 50] select symbol, ap, mx, n insert into Out;
end;
"""
PT_W, PT_CAP, PT_SYMBOLS, PT_EVENTS = 50, 1024, 1000, 1_000_000

# patterns inside a partition (see partition_pattern_path_phase): the
# partitioned pattern_2state (PPF, the fast route), a count (PPC) and an
# absent pattern under playback (PPA, the scan with its TIMER steps)
PP_APP = """{playback}@app:batch(size='{batch}') @app:partitionCapacity(size='{cap}')
define stream StockStream (symbol string, price float, volume long);
partition with (symbol of StockStream) begin
  @info(name='q') from {pattern}
    select {select} insert into Out;
end;
"""
PP_PATTERNS = {
    "PPF": ("every e1=StockStream[price > 95] -> e2=StockStream[price < 5] within 1 min",
            "e1.symbol as s, e1.price as p1, e2.price as p2"),
    "PPC": ("every a1=StockStream[price > 90]<2:4> -> a2=StockStream[price < 10]",
            "a1[0].symbol as s, a1[0].price as p1, a1[1].price as p2, a2.price as p3"),
    "PPA": ("every e1=StockStream[price > 95] -> not StockStream[price < 5] for 100 milliseconds",
            "e1.symbol as s, e1.price as p1"),
}
PP_EVENTS, PPA_BATCHES = 1_000_000, 8


def partition_pattern_app(path: str, batch: int, cap: int) -> str:
    pattern, select = PP_PATTERNS[path]
    return PP_APP.format(playback="@app:playback\n" if path == "PPA" else "", batch=batch,
                         cap=cap, pattern=pattern, select=select)


# the time and batch windows inside a partition (see partition_windows_path_phase)
_PTW_STREAM = "define stream StockStream (symbol string, price float, volume long, ets long);"
PTW_APPS = {
    # per-symbol sliding event-time statistics over one minute
    "PTE": """@app:batch(size='{batch}') @app:partitionCapacity(size='{cap}')
%s
partition with (symbol of StockStream) begin
@info(name='q') from StockStream#window.externalTime(ets, 60 sec)
select symbol, avg(price) as ap, max(price) as mx, count() as n insert into Out;
end;""" % _PTW_STREAM,
    # per-band tumbling one-second reports per symbol
    "PTB": """@app:batch(size='{batch}') @app:partitionCapacity(size='{cap}')
@app:groupCapacity(size='1024') @app:playback
%s
partition with (price < 33 as 'low' or price < 66 as 'mid' or price >= 66 as 'high'
                of StockStream) begin
@info(name='q') from StockStream#window.timeBatch(1 sec)
select symbol, avg(price) as ap, sum(volume) as v, count() as n group by symbol
insert into Out;
end;""" % _PTW_STREAM,
    # PTE on the wall-clock time window under playback: TIMER steps reach
    # every partition
    "PTT": """@app:batch(size='{batch}') @app:partitionCapacity(size='{cap}') @app:playback
%s
partition with (symbol of StockStream) begin
@info(name='q') from StockStream#window.time(1 sec)
select symbol, avg(price) as ap, max(price) as mx, count() as n insert into Out;
end;""" % _PTW_STREAM,
}


def partition_window_app(path: str, batch: int, cap: int) -> str:
    return PTW_APPS[path].format(batch=batch, cap=cap)


# joins and the sort and frequent windows inside a partition (see
# partition_join_path_phase): fills matched to resting quotes of the same
# instrument (PJ, path J's equality join made per symbol), a per-symbol
# top-10 price book (PSW, path SW per key) and per-symbol recurring lot
# sizes (PFQ, a surveillance query)
_PJ_HEAD = "@app:batch(size='{batch}') @app:partitionCapacity(size='{cap}')\n"
PJ_APPS = {
    "PJ": _PJ_HEAD + """define stream Trades (symbol string, price float, volume long);
define stream Quotes (symbol string, price float, volume long);
partition with (symbol of Trades, symbol of Quotes) begin
@info(name='q') from Trades#window.length(50) as t join Quotes#window.length(50) as q
on t.volume == q.volume
select t.symbol as s, t.price as tp, q.price as qp, t.volume as v insert into Out;
end;""",
    "PSW": _PJ_HEAD + """define stream StockStream (symbol string, price float, volume long);
partition with (symbol of StockStream) begin
@info(name='q') from StockStream#window.sort(10, price, 'desc', volume, 'asc')
select symbol, price, volume, count() as n, sum(volume) as v insert all events into Out;
end;""",
    "PFQ": _PJ_HEAD + """define stream StockStream (symbol string, price float, volume long);
partition with (symbol of StockStream) begin
@info(name='q') from StockStream#window.frequent(10, volume)
select symbol, volume, count() as c insert all events into Out;
end;""",
}


def partition_join_app(path: str, batch: int, cap: int) -> str:
    return PJ_APPS[path].format(batch=batch, cap=cap)



def rows_match(a, b, tol=RTOL):
    """bench.py:_rows_match: floats within a relative tol (floor 1.0)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(rows_match(x, y, tol) for x, y in zip(a, b))
    if isinstance(a, float):
        if b == 0:
            return abs(a) < tol
        return abs(a - b) <= tol * max(1.0, abs(a), abs(b))
    return a == b


def stock_data(n: int, seed: int = 7) -> dict:
    """bench.py:_make_stock_data: pre-interned symbol ids 1..8."""
    rng = np.random.default_rng(seed)
    return {
        "ts": np.arange(n, dtype=np.int64) + 1_700_000_000_000,
        "symbol": rng.integers(1, 9, size=n).astype(np.int32),
        "price": rng.uniform(0.0, 100.0, size=n).astype(np.float32),
        "volume": rng.integers(1, 1000, size=n).astype(np.int64),
    }


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Mean wall time per call on the device, from CUDA events (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flat(v)]
    return [tree]


def max_abs_err(torch, got, want) -> float:
    """Largest |got - want| over a tree of tensors; raises on any mismatch
    of shape or dtype, or of value beyond the stated tolerance (floats:
    relative 2e-4 of the largest running magnitude so far, floor 1.0 — the
    sums are taken in another order; everything else: exact)."""
    err = 0.0
    for g, w in zip(flat(got), flat(want), strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.dtype}{list(g.shape)} vs {w.dtype}{list(w.shape)}")
        if g.dtype.is_floating_point:
            gn, wn = g.double().cpu().numpy(), w.double().cpu().numpy()
            if not np.array_equal(np.isnan(gn), np.isnan(wn)):
                raise AssertionError("NaN positions differ")
            ok = ~np.isnan(gn)
            d = np.abs(gn - wn)[ok].reshape(-1)
            scale = np.maximum.accumulate(np.maximum(np.abs(gn), np.abs(wn))[ok].reshape(-1))
            if d.size and not np.all(d <= RTOL * np.maximum(1.0, scale)):
                raise AssertionError(f"float mismatch, max abs {d.max()}")
            err = max(err, float(d.max()) if d.size else 0.0)
        elif not torch.equal(g, w):
            raise AssertionError("integer/bool mismatch")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_phase(torch, dev) -> dict:
    from siddhi_tpu_torch.core.aggregators import window_extreme, window_extreme_ref
    from siddhi_tpu_torch.core.event import EventBatch, StreamSchema
    from siddhi_tpu_torch.core.types import AttrType
    from siddhi_tpu_torch.core.windows import (
        SlidingWindow,
        length_window_step,
        length_window_step_ref,
    )
    from siddhi_tpu_torch.ops.prefix import running_sum, running_sum_ref

    schema = StreamSchema("S", [("symbol", AttrType.STRING), ("price", AttrType.FLOAT),
                                ("volume", AttrType.LONG)])
    rng = np.random.default_rng(2024)
    res = {k: {"max_abs_err": 0.0} for k in ("length_window_step", "running_sum",
                                               "window_extreme")}

    def batch_of(b, ragged):
        d = stock_data(b, seed=int(rng.integers(1 << 30)))
        valid = d["price"] > 50  # the main path's filter
        kind = np.zeros(b, np.int8)
        if ragged:
            d["price"] = arith_traps(rng, d["price"])  # subnormal operands, kept valid
            valid |= np.isin(d["price"], ARITH_TRAPS)
            valid &= np.arange(b) < rng.integers(b // 2, b + 1)
            kind[rng.random(b) < 0.05] = 2  # TIMER rows pass through untouched
        return EventBatch(
            ts=torch.from_numpy(d["ts"]).to(dev), kind=torch.from_numpy(kind).to(dev),
            valid=torch.from_numpy(valid).to(dev),
            cols={n: torch.from_numpy(d[n]).to(dev) for n in ("symbol", "price", "volume")},
        )

    main = {}
    for b, w, ragged, steps in ((MAIN_BATCH, MAIN_W, False, 3), (33, 5, True, 4),
                                (4097, MAIN_W, True, 3)):
        state = SlidingWindow(schema, "S", w, dev).init_state()
        for step in range(steps):
            batch = batch_of(b, ragged)
            got = length_window_step(state, batch, w)
            want = length_window_step_ref(state, batch, w)
            torch.cuda.synchronize()
            out_g, out_w = got[0], want[0]
            tree_g = [out_g.ts, out_g.kind, out_g.valid, out_g.cols, got[1], got[2], got[3]]
            tree_w = [out_w.ts, out_w.kind, out_w.valid, out_w.cols, want[1], want[2], want[3]]
            res["length_window_step"]["max_abs_err"] = max(
                res["length_window_step"]["max_abs_err"], max_abs_err(torch, tree_g, tree_w))
            # K2 on this step's signed contributions (the avg's sum and count)
            sign = (out_w.valid & (out_w.kind == 0)).to(torch.float32) - (
                out_w.valid & (out_w.kind == 1)).to(torch.float32)
            contrib = torch.where(sign != 0, out_w.cols["price"] * sign, 0.0)
            reset = torch.zeros_like(out_w.valid)
            if ragged:
                reset = torch.from_numpy(rng.random(2 * b) < 0.02).to(dev)
            base = torch.full((), float(rng.uniform(0, 500)), device=dev)
            cases = [(contrib, base), (sign.to(torch.int64), base.to(torch.int64))]
            for c, bs in cases:
                g = running_sum(c, reset, bs)
                r = running_sum_ref(c, reset, bs)
                res["running_sum"]["max_abs_err"] = max(
                    res["running_sum"]["max_abs_err"], max_abs_err(torch, list(g), list(r)))
            if ragged:
                # sums exact in any order: every subnormal flushed, equal
                # values (the sign of a zero sum follows the formulation)
                c = torch.from_numpy(rng.choice(EXACT_SUM_VALUES, 2 * b)).to(dev)
                bs = torch.tensor(float(rng.choice(EXACT_SUM_VALUES)), device=dev)
                exact_values(torch, list(running_sum(c, reset, bs)),
                             list(running_sum_ref(c, reset, bs)))
            # K3 over this step's window elements
            vals = torch.cat([state["cols"]["price"], batch.cols["price"]])
            for is_min in (True, False):
                g = window_extreme(vals, want[1], want[2], 2 * b, is_min, AttrType.FLOAT)
                r = window_extreme_ref(vals, want[1], want[2], 2 * b, is_min, AttrType.FLOAT)
                res["window_extreme"]["max_abs_err"] = max(
                    res["window_extreme"]["max_abs_err"], max_abs_err(torch, g, r))
            if b == MAIN_BATCH and step == steps - 1:
                main = dict(state=state, batch=batch, want=want, contrib=contrib,
                            reset=reset, base=base, vals=vals)
            state = want[3]
        print(f"kernel check B={b} W={w} ragged={ragged}: ok", flush=True)

    # times at the main path's shapes (B=32768, W=50: 2B = 65536 flow rows)
    m = main
    b, w = MAIN_BATCH, MAIN_W
    k1 = res["length_window_step"]
    k1["ms"] = time_ms(torch, lambda: length_window_step(m["state"], m["batch"], w), 50)
    k1["plain_ms"] = time_ms(torch, lambda: length_window_step_ref(m["state"], m["batch"], w), 20)
    k1["library_ms"] = None
    col_bytes = sum(t.element_size() for t in m["batch"].cols.values())
    k1_bytes = (b * (8 + 1 + 1 + col_bytes) + w * (col_bytes + 24) + 8  # in: batch, ring
                + 2 * b * (8 + 1 + 1 + col_bytes) + (w + b) * 8  # out rows, birth/death
                + w * (col_bytes + 24) + 8)  # new ring
    k1["bound_ms"], k1["bound_by"] = k1_bytes / MEM_BYTES_PER_S * 1e3, "bytes"

    k2 = res["running_sum"]
    c, rs, bs = m["contrib"], m["reset"], m["base"]
    k2["ms"] = time_ms(torch, lambda: running_sum(c, rs, bs), 100)
    k2["plain_ms"] = time_ms(torch, lambda: running_sum_ref(c, rs, bs), 100)
    k2["library_ms"] = time_ms(torch, lambda: torch.cumsum(c, 0), 100)
    n = c.shape[0]
    k2_bytes, k2_ops = n * (4 + 1) + n * 4 + 8, n
    k2["bound_ms"], k2["bound_by"] = max(
        (k2_bytes / MEM_BYTES_PER_S * 1e3, "bytes"), (k2_ops / FP32_OPS_PER_S * 1e3, "operations"))

    k3 = res["window_extreme"]
    birth, death, vals = m["want"][1], m["want"][2], m["vals"]
    k3["ms"] = time_ms(torch, lambda: window_extreme(vals, birth, death, 2 * b, True,
                                                     AttrType.FLOAT), 10)
    k3["plain_ms"] = time_ms(torch, lambda: window_extreme_ref(vals, birth, death, 2 * b, True,
                                                               AttrType.FLOAT), 3)
    k3["library_ms"] = None
    # data-dependent work: one comparison per (row, element alive at that row)
    alive = (torch.clamp(torch.minimum(death.long(), torch.tensor(2 * b, device=dev)), min=0)
             - torch.clamp(birth.long(), min=0)).clamp(min=0).sum().item()
    k3_bytes = vals.numel() * (4 + 4 + 4) + 2 * b * 4
    k3["bound_ms"], k3["bound_by"] = max(
        (k3_bytes / MEM_BYTES_PER_S * 1e3, "bytes"), (alive / FP32_OPS_PER_S * 1e3, "operations"))
    for name, r in res.items():
        print(f"kernel {name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) library_ms={r['library_ms']} "
              f"max_abs_err={r['max_abs_err']}", flush=True)
    return res


def exact_values(torch, got, want) -> None:
    """Exact check of float sums by value (a zero's sign aside): raises on
    any difference, a subnormal against a zero among them."""
    if max_abs_err(torch, got, want) != 0.0:
        raise AssertionError("float values differ")


def same_bits_but_nan(torch, got, want) -> None:
    """`same_bits` where a float NaN may carry any payload (arithmetic on
    the host and on the card makes different NaNs): NaN positions equal,
    every other element bit for bit."""
    g, w = flat(got), flat(want)
    nan_g = [x.isnan() if x.dtype.is_floating_point else None for x in g]
    nan_w = [x.isnan() if x.dtype.is_floating_point else None for x in w]
    for a, b in zip(nan_g, nan_w, strict=True):
        if a is not None and not torch.equal(a, b):
            raise AssertionError("NaN positions differ")
    same_bits(torch, [torch.where(m, 0, x) if m is not None else x for x, m in zip(g, nan_g)],
              [torch.where(m, 0, x) if m is not None else x for x, m in zip(w, nan_w)])


def same_bits(torch, got, want) -> float:
    """Exact check of a tree of tensors (floats bit for bit, NaN fills
    included); raises on any difference, else returns 0.0."""
    for g, w in zip(flat(got), flat(want), strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.dtype}{list(g.shape)} vs {w.dtype}{list(w.shape)}")
        if g.dtype != torch.bool:
            g, w = (x.contiguous().reshape(-1).view(torch.uint8) for x in (g, w))
        if not torch.equal(g, w):
            raise AssertionError("bitwise mismatch")
    return 0.0


def encode_chunk(torch, dev, schema, keep, enc, chunks):
    """Encode micro-batches with the wire codec the fused path uses; returns
    (plan, wire [K, nb], counts [K], bases [K]) on the card."""
    encode, decode, nb = schema.wire_codec(chunks[0][2], keep, enc)
    K = len(chunks)
    wire = np.zeros((K, nb), np.uint8)
    counts = np.zeros(K, np.int32)
    bases = np.zeros(K, np.int64)
    for k, (ts, cols, _cap, n) in enumerate(chunks):
        if n:
            _buf, bases[k] = encode(ts, cols, n, out=wire[k])
        counts[k] = n
    return decode.plan, *(torch.from_numpy(x).to(dev) for x in (wire, counts, bases))


def fused_kernel_phase(torch, dev) -> dict:
    """K4 (wire decode) and K5 (deliver pack) against their plain versions,
    exactly: at the main path's shapes (the quickstart wire, B=32768, K=8 as
    the main path's calls give it and K=32 as a full chunk; K5 over 2B=65536
    step rows with the avg app's 16-byte rows) and ragged ones (K=3, 2B+5
    events over B=33, a wide int64 lane after a 2-byte lane, dict, delta and
    bitpack sections; an ALL-events pack with 17-byte rows)."""
    from siddhi_tpu_torch.core.event import StreamSchema
    from siddhi_tpu_torch.core.ingest import deliver_pack, deliver_pack_ref
    from siddhi_tpu_torch.core.types import AttrType
    from siddhi_tpu_torch.core.wire import choose_encodings, wire_decode, wire_decode_ref

    res = {"wire_decode": {"max_abs_err": 0.0}, "deliver_pack": {"max_abs_err": 0.0}}
    b = MAIN_BATCH
    stock = StreamSchema("StockStream", [("symbol", AttrType.STRING),
                                         ("price", AttrType.FLOAT), ("volume", AttrType.LONG)])
    keep = frozenset({"symbol", "price"})  # the quickstart apps never read volume
    data = stock_data(32 * b, seed=11)
    cols = ("symbol", "price", "volume")
    enc = choose_encodings(stock, keep, None, True, data["ts"][:b],
                           {k: data[k][:b] for k in cols})
    main = {}
    for K in (8, 32):
        chunks = [(data["ts"][k * b:(k + 1) * b], {c: data[c][k * b:(k + 1) * b] for c in cols},
                   b, b) for k in range(K)]
        plan, wire, counts, bases = encode_chunk(torch, dev, stock, keep, enc, chunks)
        got = wire_decode(wire, counts, bases, plan)
        torch.cuda.synchronize()
        res["wire_decode"]["max_abs_err"] = same_bits(
            torch, list(got), list(wire_decode_ref(wire, counts, bases, plan)))
        main[K] = (plan, wire, counts, bases)
        print(f"kernel check wire_decode K={K} B={b} wire {plan.row_bytes // b} B/row "
              f"{ {k: str(v) for k, v in enc.items()} }: ok", flush=True)
    # the same shapes with int16 timestamp diffs, as a burstier feed samples
    enc16 = dict(enc, __tsd__=np.dtype(np.int16))
    chunks = [(data["ts"][k * b:(k + 1) * b], {c: data[c][k * b:(k + 1) * b] for c in cols},
               b, b) for k in range(8)]
    plan, wire, counts, bases = encode_chunk(torch, dev, stock, keep, enc16, chunks)
    got = wire_decode(wire, counts, bases, plan)
    torch.cuda.synchronize()
    same_bits(torch, list(got), list(wire_decode_ref(wire, counts, bases, plan)))
    print(f"kernel check wire_decode K=8 B={b} wire {plan.row_bytes // b} B/row "
          "(int16 ts diffs, int16 symbol): ok", flush=True)
    rng = np.random.default_rng(5)
    ragged = StreamSchema("R", [("sym", AttrType.STRING), ("n", AttrType.INT),
                                ("vol", AttrType.LONG), ("seq", AttrType.LONG),
                                ("flag", AttrType.BOOL), ("price", AttrType.FLOAT)])
    r_enc = {"sym": ("dict", np.dtype(np.uint8), 8), "n": ("narrow", np.dtype(np.int16)),
             "seq": ("delta", np.dtype(np.int16)), "flag": ("bitpack",)}

    def r_batch(cap, n):
        ts = np.cumsum(rng.integers(0, 20, cap)).astype(np.int64) + 1_700_000_000_000
        return (ts, {"sym": rng.integers(1, 9, cap).astype(np.int32),
                     "n": rng.integers(-3000, 3000, cap).astype(np.int32),
                     "vol": rng.integers(-2**40, 2**40, cap).astype(np.int64),
                     "seq": np.cumsum(rng.integers(-500, 500, cap)) + 10**12,
                     "flag": rng.integers(0, 2, cap).astype(bool),
                     "price": rng.uniform(0, 100, cap).astype(np.float32)}, cap, n)

    for tsd in (np.dtype(np.int8), np.dtype(np.int32)):
        for keep_r in (None, frozenset({"sym", "vol", "flag"})):
            enc_r = dict(r_enc, __tsd__=tsd)
            plan, wire, counts, bases = encode_chunk(
                torch, dev, ragged, keep_r, enc_r, [r_batch(33, 33), r_batch(33, 33), r_batch(33, 5)])
            got = wire_decode(wire, counts, bases, plan)
            torch.cuda.synchronize()
            same_bits(torch, list(got), list(wire_decode_ref(wire, counts, bases, plan)))
    print("kernel check wire_decode K=3 B=33 ragged (dict, narrow int16 then wide int64, "
          "delta, bitpack, dropped lanes): ok", flush=True)

    def pack_case(K, R, p, dtypes):
        dv = torch.from_numpy(rng.random((K, R)) < p).to(dev)
        lanes = []
        for dt in dtypes:
            if dt == np.float32:
                a = rng.uniform(0, 100, (K, R)).astype(dt)
            else:
                a = rng.integers(-100, 1 << 30, (K, R)).astype(dt)
            lanes.append(torch.from_numpy(a).to(dev))
        got = deliver_pack(dv, lanes)
        torch.cuda.synchronize()
        same_bits(torch, got, deliver_pack_ref(dv, lanes))
        return dv, lanes

    avg_row = (np.float32, np.int32, np.int64)  # c.ap, c.symbol, ts: 16 B
    packs = {K: pack_case(K, 2 * b, 0.25, avg_row) for K in (8, 32)}
    pack_case(3, 2 * 33 + 5, 0.5, (np.float32, np.int32, np.int8, np.int64))  # ALL: 17 B
    pack_case(2, 5000, 0.0, avg_row)
    print(f"kernel check deliver_pack K=8,32 R={2 * b} W=16 and K=3 R=71 W=17: ok", flush=True)

    k4 = res["wire_decode"]
    for K in (8, 32):
        plan, wire, counts, bases = main[K]
        ms = time_ms(torch, lambda: wire_decode(wire, counts, bases, plan), 50)
        plain = time_ms(torch, lambda: wire_decode_ref(wire, counts, bases, plan), 10)
        out_row = 8 + 1 + 1 + sum(np.dtype(d).itemsize for d in ("int32", "float32", "int64"))
        nbytes = K * (12 + plan.row_bytes) + K * b * out_row
        k4[f"K{K}"] = {"ms": ms, "plain_ms": plain, "bound_ms": nbytes / MEM_BYTES_PER_S * 1e3}
    k4.update(k4["K8"], bound_by="bytes", library_ms=None)

    k5 = res["deliver_pack"]
    for K in (8, 32):
        dv, lanes = packs[K]
        ms = time_ms(torch, lambda: deliver_pack(dv, lanes), 50)
        plain = time_ms(torch, lambda: deliver_pack_ref(dv, lanes), 10)
        W = 16
        kept = int(dv.sum().item())
        nbytes = dv.numel() * (1 + W) + (-(-4 * K // W) + kept) * W
        k5[f"K{K}"] = {"ms": ms, "plain_ms": plain, "bound_ms": nbytes / MEM_BYTES_PER_S * 1e3,
                       "kept_rows": kept}
    k5.update({k: v for k, v in k5["K8"].items() if k != "kept_rows"}, bound_by="bytes",
              library_ms=None)
    for name in ("wire_decode", "deliver_pack"):
        r = res[name]
        print(f"kernel {name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.6f} (bytes) library_ms=None (K=8; K=32: "
              f"ms={r['K32']['ms']:.4f} plain_ms={r['K32']['plain_ms']:.4f} "
              f"bound_ms={r['K32']['bound_ms']:.6f}) max_abs_err=0.0", flush=True)
    return res


def grouped_kernel_phase(torch, dev) -> dict:
    """The group-by path's kernels against their plain versions on the card:
    the lengthBatch step (K6), slot assignment (K7), keyed running sum (K8,
    the int64 sum and the float32 avg sum and count of tumbling_groupby) and
    keep-last (K9, grouped and ungrouped), from the same inputs and state.
    Shapes: the main path (B=32768, lengthBatch(1024) without EXPIRED lanes:
    33,826 flow rows, 8 symbols, G=1024) for 3 carried steps; the same with
    the EXPIRED lanes (100,386 rows); ragged B=4097/n=100, B=33/n=4 and
    B=1/n=1 with holes and TIMER rows, lanes on and off; 1,000 distinct keys
    over a lengthBatch flow and over B=32768 rows with no reset (a nearly full
    table) and 2,000 (overflow past G). Ints, bools and masks exact; float32
    sums to the stated tolerance."""
    from siddhi_tpu_torch.core.event import (
        KIND_CURRENT,
        KIND_EXPIRED,
        KIND_RESET,
        EventBatch,
        StreamSchema,
    )
    from siddhi_tpu_torch.core.types import AttrType
    from siddhi_tpu_torch.core.windows import (
        BatchWindow,
        batch_window_step,
        batch_window_step_ref,
    )
    from siddhi_tpu_torch.ops.group import (
        assign_slots,
        assign_slots_ref,
        keep_last,
        keep_last_ref,
        keyed_running_sum,
        keyed_running_sum_ref,
    )

    schema = StreamSchema("StockStream", [("symbol", AttrType.STRING), ("price", AttrType.FLOAT),
                                          ("volume", AttrType.LONG)])
    names = ("batch_window_step", "assign_slots", "keyed_running_sum", "keep_last")
    res = {k: {"max_abs_err": 0.0} for k in names}
    rng = np.random.default_rng(77)

    def check(name, got, want):
        torch.cuda.synchronize()
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], max_abs_err(torch, got, want))

    def batch_of(b, n_sym, ragged):
        d = stock_data(b, seed=int(rng.integers(1 << 30)))
        d["symbol"] = rng.integers(1, n_sym + 1, size=b).astype(np.int32)
        valid = np.ones(b, bool)
        kind = np.zeros(b, np.int8)
        if ragged:
            d["price"] = arith_traps(rng, d["price"])  # subnormal operands of the avg sum
            valid &= rng.random(b) < 0.9
            kind[rng.random(b) < 0.05] = 2  # TIMER rows are not window arrivals
        return EventBatch(
            ts=torch.from_numpy(d["ts"]).to(dev), kind=torch.from_numpy(kind).to(dev),
            valid=torch.from_numpy(valid).to(dev),
            cols={n: torch.from_numpy(d[n]).to(dev) for n in ("symbol", "price", "volume")},
        )

    def group_lanes(out):
        cur = out.valid & (out.kind == KIND_CURRENT)
        exp = out.valid & (out.kind == KIND_EXPIRED)
        sign = cur.to(torch.int8) - exp.to(torch.int8)
        return sign, sign != 0, out.valid & (out.kind == KIND_RESET), cur | exp

    def group_state(g):
        return {"keys": torch.zeros(g, dtype=torch.int64, device=dev),
                "used": torch.zeros(g, dtype=torch.bool, device=dev),
                "n": torch.zeros((), dtype=torch.int32, device=dev),
                "sum": torch.zeros(g, dtype=torch.int64, device=dev),
                "avg_sum": torch.zeros(g, dtype=torch.float32, device=dev),
                "avg_count": torch.zeros(g, dtype=torch.float32, device=dev),
                "exact_sum": torch.zeros(g, dtype=torch.float32, device=dev)}

    def group_step(out, gs):
        """K7-K9 over one flow against their plain versions; returns the new
        group state (from the plain versions) and the inputs for timing."""
        sign, active, reset, emitted = group_lanes(out)
        keys = out.cols["symbol"].to(torch.int64)
        args = (gs["keys"], gs["used"], gs["n"], keys, active, reset)
        got, want = assign_slots(*args), assign_slots_ref(*args)
        flat_g = [got[0], got[1], got[2], got[3], got[4].first, got[4].bounds, got[5]]
        flat_w = [want[0], want[1], want[2], want[3], want[4].first, want[4].bounds, want[5]]
        check("assign_slots", flat_g, flat_w)
        grp, slot = want[4], want[3]
        sgn_f = sign.to(torch.float32)
        sums = {
            "sum": torch.where(sign != 0, out.cols["volume"] * sign.to(torch.int64), 0),
            "avg_sum": torch.where(sign != 0, out.cols["price"] * sgn_f, 0.0),
            "avg_count": sgn_f,
            # sums exact in any order: subnormals flushed bit for bit
            "exact_sum": torch.where(sign != 0, torch.from_numpy(
                rng.choice(EXACT_SUM_VALUES, sign.shape[0])).to(dev) * sgn_f, 0.0),
        }
        new = {"keys": want[0], "used": want[1], "n": want[2]}
        for k, contrib in sums.items():
            g = keyed_running_sum(contrib, grp, reset, gs[k], slot)
            w = keyed_running_sum_ref(contrib, grp, reset, gs[k], slot)
            check("keyed_running_sum", list(g), list(w))
            if k == "exact_sum":
                exact_values(torch, list(g), list(w))
            new[k] = w[1]
        kb = out.kind == KIND_EXPIRED
        check("keep_last", keep_last(grp.first, kb, emitted), keep_last_ref(grp.first, kb, emitted))
        seg = torch.cumsum(reset.to(torch.int32), 0, dtype=torch.int32) + kb.to(torch.int32)
        allowed = emitted & (out.kind == KIND_CURRENT)
        zeros = torch.zeros_like(allowed)
        check("keep_last", keep_last(seg, zeros, allowed), keep_last_ref(seg, zeros, allowed))
        return new, dict(args=args, grp=grp, slot=slot, reset=reset, sums=sums, kb=kb,
                         emitted=emitted, carry=gs)

    main = {}
    cases = ((MAIN_BATCH, GROUP_N, False, False, 8, 3), (MAIN_BATCH, GROUP_N, True, False, 8, 2),
             (4097, 100, True, True, 8, 3), (4097, 100, False, True, 8, 3),
             (33, 4, True, True, 5, 4), (1, 1, False, True, 2, 3),
             (MAIN_BATCH, GROUP_N, False, False, 1000, 2))
    for b, n, exp, ragged, n_sym, steps in cases:
        state = BatchWindow(schema, "StockStream", n, dev).init_state()
        gs = group_state(GROUP_G)
        for step in range(steps):
            batch = batch_of(b, n_sym, ragged)
            got = batch_window_step(state, batch, n, exp)
            want = batch_window_step_ref(state, batch, n, exp)
            og, ow = got[0], want[0]
            check("batch_window_step",
                  [og.ts, og.kind, og.valid, og.cols, got[1] if exp else [], got[2] if exp else [],
                   got[3]],
                  [ow.ts, ow.kind, ow.valid, ow.cols, want[1] if exp else [],
                   want[2] if exp else [], want[3]])
            gs, inputs = group_step(ow, gs)
            if (b, n, exp, n_sym) == (MAIN_BATCH, GROUP_N, False, 8) and step == steps - 1:
                main = dict(state=state, batch=batch, rows=ow.valid.shape[0], **inputs)
            state = want[3]
        print(f"kernel check lengthBatch B={b} n={n} expired_lanes={exp} ragged={ragged} "
              f"symbols={n_sym}: {ow.valid.shape[0]} flow rows ok", flush=True)
    # no reset: the unwindowed group-by's flow, 1,000 keys (a nearly full
    # table) then 2,000 (overflow past G)
    for n_sym in (1000, 2000):
        gs = group_state(GROUP_G)
        for step in range(2):
            batch = batch_of(MAIN_BATCH, n_sym, False)
            gs, inputs = group_step(batch, gs)
        over = bool(assign_slots_ref(*inputs["args"])[5])
        if over != (n_sym > GROUP_G):
            raise AssertionError(f"{n_sym} keys at G={GROUP_G}: overflow flag {over}")
        print(f"kernel check group-by, no reset, B={MAIN_BATCH} rows, {n_sym} keys at "
              f"G={GROUP_G}: overflow={over} ok", flush=True)

    # times at the main path's shapes: one tumbling_groupby step, 33,826 rows
    m = main
    b, n, rows, G = MAIN_BATCH, GROUP_N, main["rows"], GROUP_G
    col_bytes = 4 + 4 + 8
    k6 = res["batch_window_step"]
    k6["ms"] = time_ms(torch, lambda: batch_window_step(m["state"], m["batch"], n, False), 50)
    k6["plain_ms"] = time_ms(
        torch, lambda: batch_window_step_ref(m["state"], m["batch"], n, False), 10)
    k6["library_ms"] = None
    k6_bytes = (b * (8 + 1 + 1 + col_bytes) + 2 * n * (col_bytes + 8) + 8  # in: batch, buffers
                + rows * (8 + 1 + 1 + col_bytes) + 2 * n * (col_bytes + 8) + 8)  # out rows, buffers
    k6["bound_ms"], k6["bound_by"] = k6_bytes / MEM_BYTES_PER_S * 1e3, "bytes"

    k7 = res["assign_slots"]
    args = m["args"]
    k7["ms"] = time_ms(torch, lambda: assign_slots(*args), 50)
    k7["plain_ms"] = time_ms(torch, lambda: assign_slots_ref(*args), 10)
    k7["library_ms"] = None
    k7_bytes = rows * (8 + 1 + 1) + G * 9 + 4 + rows * (4 + 4) + G * 9 + 4 + 8 + 1
    k7["bound_ms"], k7["bound_by"] = k7_bytes / MEM_BYTES_PER_S * 1e3, "bytes"

    k8 = res["keyed_running_sum"]
    grp, slot, reset = m["grp"], m["slot"], m["reset"]
    contrib, carry = m["sums"]["avg_sum"], m["carry"]["avg_sum"]
    k8["ms"] = time_ms(torch, lambda: keyed_running_sum(contrib, grp, reset, carry, slot), 50)
    k8["plain_ms"] = time_ms(
        torch, lambda: keyed_running_sum_ref(contrib, grp, reset, carry, slot), 10)
    ci, cc = m["sums"]["sum"], m["carry"]["sum"]
    k8["int64"] = {"ms": time_ms(torch, lambda: keyed_running_sum(ci, grp, reset, cc, slot), 50)}
    k8["library_ms"] = None
    k8_bytes = rows * (4 + 4 + 4 + 1) + 8 + G * 4 + rows * 4 + G * 4
    k8["bound_ms"], k8["bound_by"] = max((k8_bytes / MEM_BYTES_PER_S * 1e3, "bytes"),
                                         (rows / FP32_OPS_PER_S * 1e3, "operations"))

    k9 = res["keep_last"]
    kb, emitted = m["kb"], m["emitted"]
    k9["ms"] = time_ms(torch, lambda: keep_last(grp.first, kb, emitted), 50)
    k9["plain_ms"] = time_ms(torch, lambda: keep_last_ref(grp.first, kb, emitted), 10)
    k9["library_ms"] = None
    k9["bound_ms"], k9["bound_by"] = rows * (4 + 1 + 1 + 1) / MEM_BYTES_PER_S * 1e3, "bytes"
    for name in names:
        r = res[name]
        print(f"kernel {name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) library_ms=None "
              f"max_abs_err={r['max_abs_err']}", flush=True)
    return res


def join_kernel_phase(torch, dev) -> dict:
    """The join slice's kernels against their plain versions on the card,
    exactly, from the same inputs and state: the sliding time-window step
    (K10) at the T path's shapes (B=8192, W=1024, time(1 sec), 3 carried
    steps, each followed by 3 one-row TIMER steps as the event-time clock
    sends them) and T2's (B=32768 with the price > 50 filter), ragged B=33
    and B=4097 with holes, TIMER rows and a gap that empties the ring into
    one TIMER row, disordered externalTime (the kernel's general branch) at
    B=33 and B=4097, and capacity early eviction (W=16); the ring view (K11)
    of a full length(100) ring (path J), the T ring, a ring with many holes
    and an empty one; the probe compaction (K12) at path J's shape (8192
    CURRENT probes against a length(100) view, cap 8192) and T's (a
    1024-slot view, cap 16384), a full outer join with misses, CURRENT plus
    EXPIRED probes, overflow past the cap, an empty view and a windowless
    side."""
    from siddhi_tpu_torch.core.event import EventBatch, StreamSchema
    from siddhi_tpu_torch.core.join import join_assemble, join_assemble_ref
    from siddhi_tpu_torch.core.types import AttrType
    from siddhi_tpu_torch.core.windows import (
        SlidingWindow,
        length_window_step_ref,
        ring_view,
        ring_view_ref,
        time_window_step,
        time_window_step_ref,
    )

    schema = StreamSchema("StockStream", [("symbol", AttrType.STRING), ("price", AttrType.FLOAT),
                                          ("volume", AttrType.LONG)])
    types = dict(schema.attrs)
    names = ("time_window_step", "ring_view", "join_assemble")
    res = {k: {"max_abs_err": 0.0} for k in names}
    rng = np.random.default_rng(404)
    col_bytes = 4 + 4 + 8

    def make_batch(b, clock, t, filt=False, ragged=False, disorder=False, gap=False):
        d = stock_data(b, seed=int(rng.integers(1 << 30)))
        step = rng.integers(0, 3, b) if ragged else np.ones(b, np.int64)
        ts = clock + np.cumsum(step).astype(np.int64)
        kind = np.zeros(b, np.int8)
        valid = d["price"] > 50 if filt else np.ones(b, bool)
        if ragged:
            valid &= rng.random(b) < 0.9
            kind[rng.random(b) < 0.05] = 2  # TIMER rows
        if gap:
            ts += 10 * t
            kind[0] = 2  # a TIMER that expires the whole ring
        vol = d["volume"]
        if disorder:  # the externalTime attribute, out of order
            vol = ts + rng.integers(-3 * t, 3 * t, b)
        cols = {"symbol": d["symbol"], "price": d["price"], "volume": vol.astype(np.int64)}
        return EventBatch(ts=torch.from_numpy(ts).to(dev), kind=torch.from_numpy(kind).to(dev),
                          valid=torch.from_numpy(valid).to(dev),
                          cols={n: torch.from_numpy(v).to(dev) for n, v in cols.items()})

    def timer_batch(t_ms):
        return EventBatch(ts=torch.full((1,), t_ms, dtype=torch.int64, device=dev),
                          kind=torch.full((1,), 2, dtype=torch.int8, device=dev),
                          valid=torch.ones(1, dtype=torch.bool, device=dev),
                          cols={"symbol": torch.zeros(1, dtype=torch.int32, device=dev),
                                "price": torch.full((1,), float("nan"), device=dev),
                                "volume": torch.zeros(1, dtype=torch.int64, device=dev)})

    def k10(state, batch, w, t, ext):
        bwts = batch.cols["volume"] if ext else batch.ts
        got = time_window_step(state, batch, bwts, w, t)
        want = time_window_step_ref(state, batch, bwts, w, t)
        torch.cuda.synchronize()
        flat_g = [got[0].ts, got[0].kind, got[0].valid, got[0].cols, got[1], got[2], got[3], got[4]]
        flat_w = [want[0].ts, want[0].kind, want[0].valid, want[0].cols, want[1], want[2], want[3],
                  want[4]]
        same_bits(torch, flat_g, flat_w)
        return want

    main, rings = {}, {}
    cases = (("T", JOIN_BATCH, TIME_W, 1000, dict(), False, 3),
             ("T2", MAIN_BATCH, TIME_W, 1000, dict(filt=True), False, 3),
             ("ragged", 33, 16, 37, dict(ragged=True), False, 4),
             ("ragged", 4097, TIME_W, 37, dict(ragged=True), False, 3),
             ("disorder", 33, 16, 37, dict(ragged=True, disorder=True), True, 4),
             ("disorder", 4097, TIME_W, 300, dict(disorder=True), True, 3),
             ("capacity", 4097, 16, 1000, dict(), False, 3))
    for label, b, w, t, kw, ext, steps in cases:
        state = SlidingWindow(schema, "S", w, dev, duration_ms=t).init_state()
        clock, expired, timers = 1_700_000_000_000, 0, 0
        for step in range(steps):
            batch = make_batch(b, clock, t, gap=label == "ragged" and step == 2, **kw)
            clock = int(batch.ts.max().item())
            if label in ("T", "T2"):
                main[label] = (state, batch)
            want = k10(state, batch, w, t, ext)
            expired += int((want[0].valid & (want[0].kind == 1)).sum().item())
            state = want[3]
            if label == "T":
                for _ in range(3):  # the event-time clock's TIMER rows
                    tb = timer_batch(int(want[4].item()))
                    main["timer"] = (state, tb)
                    want = k10(state, tb, w, t, ext)
                    state = want[3]
                    timers += 1
                clock += 1000
        rings[label] = state
        print(f"kernel check time_window_step {label} B={b} W={w} t={t} externalTime={ext}: "
              f"{expired} EXPIRED rows, {timers} TIMER steps ok", flush=True)

    # K11 on the J ring (a full length(100) ring after 3 batches of 8192),
    # the T ring, a ring with many holes and an empty one
    j_state = SlidingWindow(schema, "S", JOIN_W, dev).init_state()
    for _ in range(3):
        j_state = length_window_step_ref(j_state, make_batch(JOIN_BATCH, 0, 1), JOIN_W)[3]
    views = {}
    for label, st in (("J", j_state), ("T", rings["T"]), ("holes", rings["ragged"]),
                      ("empty", SlidingWindow(schema, "S", 64, dev).init_state())):
        got, want = ring_view(st), ring_view_ref(st)
        torch.cuda.synchronize()
        same_bits(torch, list(got), list(want))
        views[label] = want
        print(f"kernel check ring_view {label} W={st['seq'].shape[0]}: "
              f"{int(want[2].sum().item())} live slots ok", flush=True)

    # K12: probes against views, as CompiledJoin._assemble forms them
    def k12(probes, view, outer, cap, on=True):
        batch, rows = probes
        vcols, vts, vmask = view
        pair = rows[:, None] & vmask[None, :]
        if on:
            pair = pair & (batch.cols["volume"][:, None] == vcols["volume"][None, :])
        kind = torch.where(batch.kind == 1, 1, 0).to(torch.int8)
        args = (pair, rows, outer, cap, batch.ts, kind, batch.cols, vts, vcols, types)
        got, want = join_assemble(*args), join_assemble_ref(*args)
        torch.cuda.synchronize()
        fields = ("ts", "kind", "valid", "probe_cols", "partner_cols", "partner_ts", "overflow")
        same_bits(torch, [getattr(got, f) for f in fields], [getattr(want, f) for f in fields])
        return args, want

    def probes_of(b, p_valid=1.0, expired=False):
        batch = make_batch(b, 0, 1)
        rows = torch.from_numpy(rng.random(b) < p_valid).to(dev)
        if expired:  # CURRENT then EXPIRED probe sets, as `insert all events` forms them
            kind = torch.cat([torch.zeros(b // 2, dtype=torch.int8, device=dev),
                              torch.ones(b - b // 2, dtype=torch.int8, device=dev)])
            batch = EventBatch(ts=batch.ts, kind=kind, valid=batch.valid, cols=batch.cols)
        return batch, rows

    j_args, j_want = k12(probes_of(JOIN_BATCH), views["J"], False, JOIN_CAP)
    t_args, t_want = k12(probes_of(JOIN_BATCH), views["T"], False, TIME_JOIN_CAP)
    small = SlidingWindow(schema, "S", 16, dev).init_state()
    small = length_window_step_ref(small, make_batch(33, 0, 1), 16)[3]
    small_view = ring_view_ref(small)
    k12(probes_of(33, 0.7), small_view, True, 64)  # full outer with misses
    k12(probes_of(2 * 33, 0.8, expired=True), small_view, True, 128)  # CURRENT + EXPIRED
    _a, over = k12(probes_of(4097), small_view, False, 7, on=False)  # overflow past the cap
    if not bool(over.overflow):
        raise AssertionError("join_assemble: overflow past the cap not flagged")
    empty_view = ring_view_ref(SlidingWindow(schema, "S", 64, dev).init_state())
    k12(probes_of(33, 0.7), empty_view, True, 64)  # an empty view: all misses
    nowin = ({n: torch.zeros(1, dtype=v.dtype, device=dev) for n, v in small_view[0].items()},
             torch.zeros(1, dtype=torch.int64, device=dev),
             torch.zeros(1, dtype=torch.bool, device=dev))
    k12(probes_of(33), nowin, True, 64)  # a windowless side
    print(f"kernel check join_assemble J: {int(j_want.valid.sum().item())} matches of "
          f"{JOIN_BATCH} probes x {JOIN_W}; T: {int(t_want.valid.sum().item())} of "
          f"{JOIN_BATCH} x {TIME_W}; outer misses, EXPIRED probes, overflow, empty view, "
          "windowless side: ok", flush=True)

    # times at the paths' shapes
    k10r = res["time_window_step"]
    st, bt = main["T2"]
    bwts = bt.ts
    k10r["ms"] = time_ms(torch, lambda: time_window_step(st, bt, bwts, TIME_W, 1000), 50)
    k10r["plain_ms"] = time_ms(torch, lambda: time_window_step_ref(st, bt, bwts, TIME_W, 1000), 10)
    k10r["library_ms"] = None
    b, w = MAIN_BATCH, TIME_W
    k10_bytes = (b * (8 + 1 + 1 + 8 + col_bytes) + w * (col_bytes + 24) + 8  # in: batch, ring
                 + (w + 2 * b) * (8 + 1 + 1 + col_bytes) + (w + b) * 8  # out rows, birth/death
                 + w * (col_bytes + 24) + 16)  # new ring, next_timer
    k10r["bound_ms"], k10r["bound_by"] = k10_bytes / MEM_BYTES_PER_S * 1e3, "bytes"
    others = {}
    for label, (st2, bt2) in (("B8192", main["T"]), ("timer_B1", main["timer"])):
        others[label] = time_ms(torch, lambda: time_window_step(st2, bt2, bt2.ts, TIME_W, 1000), 50)
    k10r["other_shapes_ms"] = others

    k11 = res["ring_view"]
    k11["ms"] = time_ms(torch, lambda: ring_view(j_state), 100)
    k11["plain_ms"] = time_ms(torch, lambda: ring_view_ref(j_state), 100)
    k11["library_ms"] = time_ms(torch, lambda: torch.argsort(j_state["seq"]), 100)
    k11["bound_ms"] = JOIN_W * (8 + 2 * (col_bytes + 8) + 1) / MEM_BYTES_PER_S * 1e3
    k11["bound_by"] = "bytes"
    k11["W1024_ms"] = time_ms(torch, lambda: ring_view(rings["T"]), 100)

    k12r = res["join_assemble"]
    k12r["ms"] = time_ms(torch, lambda: join_assemble(*j_args), 50)
    k12r["plain_ms"] = time_ms(torch, lambda: join_assemble_ref(*j_args), 10)
    pair = j_args[0]
    k12r["library_ms"] = time_ms(torch, lambda: torch.nonzero(pair), 50)
    r_, w_ = pair.shape
    k12_bytes = (r_ * w_ + r_ * (1 + 8 + 1 + col_bytes) + w_ * (8 + col_bytes)  # mask, lanes in
                 + JOIN_CAP * (8 + 1 + 1 + 2 * col_bytes + 8) + 1)  # joined lanes out
    k12r["bound_ms"], k12r["bound_by"] = k12_bytes / MEM_BYTES_PER_S * 1e3, "bytes"
    k12r["T_shape_ms"] = time_ms(torch, lambda: join_assemble(*t_args), 50)
    for name in names:
        r = res[name]
        print(f"kernel {name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) library_ms={r['library_ms']} "
              f"max_abs_err={r['max_abs_err']}", flush=True)
    print(f"kernel time_window_step at B=8192: {others['B8192']:.4f} ms, one-row TIMER step: "
          f"{others['timer_B1']:.4f} ms; ring_view at W=1024: {k11['W1024_ms']:.4f} ms; "
          f"join_assemble at T's shape: {k12r['T_shape_ms']:.4f} ms", flush=True)
    return res


def pattern_kernel_phase(torch, dev) -> dict:
    """The pattern slice's kernels against their plain versions on the card,
    exactly (every lane of the token table and the emission buffer, entry
    rows, out_n and the overflow flags), from the same random token tables
    and chunks: the slot pass (K13) at path P's shape (T=4096, C=2048) for
    the `every` fork at slot 0 and the advance at slot 1 with a row-only
    condition, and with a cross-ref [T, C] condition (b.price < a.price);
    a strict sequence pass; a fork that runs out of free lanes; the count
    route's tail pass; the count pass (K14) at path C's shape (T=512,
    C=8192, K=4), with its lanes exhausted, with the generation cap
    reached, and an unbounded <2:>; the completions (K15) at P's shape with
    the within purge, into a buffer that overflows, and at C's shape; each
    also at a ragged C=33."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core.pattern import (
        pattern_advance,
        pattern_advance_ref,
        pattern_count,
        pattern_count_ref,
        pattern_emit,
        pattern_emit_ref,
    )

    names = ("pattern_advance", "pattern_count", "pattern_emit")
    res = {k: {"max_abs_err": 0.0} for k in names}
    rng = np.random.default_rng(505)
    t_base = 1_700_000_000_000

    def prog_of(ql, T, chunk=None):
        extra = f"@app:patternChunk(size='{chunk}')\n" if chunk else ""
        app = (f"@app:patternCapacity(size='{T}')\n{extra}define stream S (symbol string, "
               f"price float, volume long);\n@info(name='q') {ql} insert into Out;")
        return SiddhiManager(device=dev).create_siddhi_app_runtime(app).queries["q"].prog

    def random_tok(prog, count_route, active=0.5, done=False):
        tok = prog.init_state(0)
        T, S = prog.T, len(prog.slots)
        act = rng.random(T) < active
        act[0] = True
        slot = rng.integers(0, S + 1 if done else S, T).astype(np.int32)
        slot[0] = 0
        start = np.where(rng.random(T) < 0.3, -1, t_base - rng.integers(0, 2000, T))
        start[0] = -1
        lanes = {"active": act, "slot": slot, "start_ts": start.astype(np.int64),
                 "entry_ts": (t_base - rng.integers(0, 500, T)).astype(np.int64)}
        tok.update({k: torch.from_numpy(v).to(dev) for k, v in lanes.items()})
        for a, c in zip(prog.refs, tok["caps"]):
            hi = a.cap + 3 if count_route else 2
            n = rng.integers(0, hi, T).astype(np.int32)
            n[0] = 0  # the arming token is virgin
            c["n"] = torch.from_numpy(n).to(dev)
            c["ts"] = torch.from_numpy(
                (t_base - rng.integers(0, 500, tuple(c["ts"].shape))).astype(np.int64)).to(dev)
            for name, arr in c["cols"].items():
                shape = tuple(arr.shape)
                vals = (rng.uniform(0, 100, shape) if arr.dtype.is_floating_point
                        else rng.integers(1, 9, shape))
                c["cols"][name] = torch.from_numpy(vals).to(dtype=arr.dtype, device=dev)
        return tok

    def make_chunk(C, dense=False):
        d = stock_data(C, seed=int(rng.integers(1 << 30)))
        if dense:  # most prices extreme: many matches at both slots
            d["price"] = np.where(rng.random(C) < 0.5, 99.5, 0.5).astype(np.float32)
        ts = (t_base + np.cumsum(rng.integers(0, 3, C))).astype(np.int64)
        kind = np.where(rng.random(C) < 0.03, 2, 0).astype(np.int8)
        valid = rng.random(C) < 0.95
        ev = {k: torch.from_numpy(d[k]).to(dev) for k in ("symbol", "price", "volume")}
        return (torch.from_numpy(ts).to(dev), torch.from_numpy(kind).to(dev),
                torch.from_numpy(valid).to(dev), ev)

    no_ovf = torch.zeros((), dtype=torch.bool, device=dev)

    def entry_rows(T, C):
        er = rng.integers(-1, max(C // 2, 1), T)
        er[rng.random(T) < 0.6] = -1
        return torch.from_numpy(er.astype(np.int32)).to(dev)

    def k13_args(prog, p, tok, C, dense=False, tail=False):
        ts, kind, valid, ev = make_chunk(C, dense)
        v = valid & (kind == 0)
        now = torch.full((), t_base, dtype=torch.int64, device=dev)
        cond = prog._slot_cond(p, tok, ev, ts, now)
        return (prog, p, tok, entry_rows(prog.T, C), v, ts, ev, cond, no_ovf, tail)

    def k13(label, args, want_overflow=None):
        got, want = pattern_advance(*args), pattern_advance_ref(*args)
        torch.cuda.synchronize()
        same_bits(torch, list(got), list(want))
        if want_overflow is not None and bool(want[2]) != want_overflow:
            raise AssertionError(f"pattern_advance {label}: overflow {bool(want[2])}")
        moved = int((want[0]["slot"] != args[2]["slot"]).sum().item())
        print(f"kernel check pattern_advance {label}: T={args[0].T} C={args[5].shape[0]}, "
              f"{moved} lanes moved, overflow {bool(want[2])}: ok", flush=True)
        return args

    p2 = prog_of("from every a=S[price > 95] -> b=S[price < 5] within 1 sec "
                 "select a.symbol as s1, b.symbol as s2", PATTERN_T)
    cross = prog_of("from every a=S[price > 50] -> b=S[price < a.price] "
                    "select a.symbol as s1, b.symbol as s2", PATTERN_T)
    seq = prog_of("from every a=S[price > 50], b=S[price < 50], c=S[price > 20] "
                  "select a.symbol as s1, c.price as pc", 64)
    small = prog_of("from every a=S[price > 95] -> b=S[price < 5] within 1 sec "
                    "select a.symbol as s1, b.symbol as s2", 64)
    tail3 = prog_of("from every a=S[price > 85]<1:3> -> b=S[price < 15] -> "
                    "c=S[volume > b.volume] select a[0].volume as v0, c.volume as vc", COUNT_T,
                    COUNT_C)
    fork_p = k13("P fork (slot 0)", k13_args(p2, 0, random_tok(p2, False, 0.05), PATTERN_C))
    adv_p = k13("P advance (slot 1, row-only)",
                k13_args(p2, 1, random_tok(p2, False, 0.5), PATTERN_C))
    cross_p = k13("cross-ref advance ([T, C] condition)",
                  k13_args(cross, 1, random_tok(cross, False, 0.5), PATTERN_C))
    k13("strict sequence", k13_args(seq, 1, random_tok(seq, False), 2048))
    k13("fork out of lanes", k13_args(small, 0, random_tok(small, False, 0.97), 2048, True),
        want_overflow=True)
    k13("count tail (slot 2)", k13_args(tail3, 2, random_tok(tail3, True), COUNT_C, tail=True))
    for label, prog, p in (("ragged fork", small, 0), ("ragged advance", small, 1),
                           ("ragged strict", seq, 2)):
        k13(label, k13_args(prog, p, random_tok(prog, False), 33, dense=True))

    def k14_args(prog, tok, C, dense=False):
        ts, kind, valid, ev = make_chunk(C, dense)
        v = valid & (kind == 0)
        now = torch.full((), t_base, dtype=torch.int64, device=dev)
        masks = []
        for p in (0, 1):
            atom = prog.slots[p].atoms[0]
            env = prog._row_env(ev, ts, now, atom)
            mask = v
            for c in prog._conds[(p, atom.ref_idx)]:
                mask = mask & torch.broadcast_to(c(env), (C,))
            masks.append(mask)
        return (prog, tok, masks[0], masks[1], ts, ev, ev, no_ovf)

    def k14(label, args, want_overflow=None):
        got, want = pattern_count(*args), pattern_count_ref(*args)
        torch.cuda.synchronize()
        same_bits(torch, list(got), list(want))
        if want_overflow is not None and bool(want[2]) != want_overflow:
            raise AssertionError(f"pattern_count {label}: overflow {bool(want[2])}")
        armed = int((want[0]["active"] & ~args[1]["active"]).sum().item())
        print(f"kernel check pattern_count {label}: T={args[0].T} C={args[4].shape[0]}, "
              f"{armed} generations armed, overflow {bool(want[2])}: ok", flush=True)
        return args

    cq = "from every a=S[price > 90]<2:4> -> b=S[price < 10] select b.symbol as s2"
    cs = prog_of(cq, COUNT_T, COUNT_C)
    cs_caps = prog_of("from every a=S[price > 90]<2:4> -> b=S[price < 10] "
                      "select a[0].volume as v0, a[last].price as pl, b.symbol as s2",
                      COUNT_T, COUNT_C)
    plus = prog_of("from every a=S[price > 60]<2:> -> b=S[price < 30] "
                   "select a[0].volume as v0, a[last].volume as vl, b.volume as vb", 64)
    gcap = prog_of(cq, 16)
    c_args = k14("C", k14_args(cs, random_tok(cs, True, 0.1), COUNT_C))
    k14("C with capture lanes", k14_args(cs_caps, random_tok(cs_caps, True), COUNT_C))
    k14("lanes exhausted", k14_args(cs, random_tok(cs, True, 0.99), COUNT_C, True),
        want_overflow=True)
    k14("generation cap (T=16)", k14_args(gcap, random_tok(gcap, True, 0.2), COUNT_C, True),
        want_overflow=True)
    k14("unbounded <2:>", k14_args(plus, random_tok(plus, True), 2048))
    k14("ragged", k14_args(cs_caps, random_tok(cs_caps, True), 33))
    k14("three refs (generation lanes cleared)", k14_args(tail3, random_tok(tail3, True), 2048))
    other = list(k14_args(cs_caps, random_tok(cs_caps, True), 2048))
    other[3] = torch.zeros_like(other[3])  # a step of another stream: slot 1 sees no row
    other[6] = None
    k14("slot 1 on another stream", tuple(other))

    def k15_args(prog, C, cap, fill, purge):
        tok = random_tok(prog, not purge, 0.5, done=True)
        ts, kind, valid, _ev = make_chunk(C)
        out = prog.init_out(cap)
        out_n = torch.full((), int(cap * fill), dtype=torch.int32, device=dev)
        now = torch.full((), t_base + 7, dtype=torch.int64, device=dev)
        return (prog, tok, entry_rows(prog.T, C), ts, valid & (kind == 0), now, out, out_n,
                no_ovf, purge)

    def fresh(args):  # the emission buffer and out_n are updated in place
        a = list(args)
        a[6] = {k: v.clone() for k, v in a[6].items()}
        a[7] = a[7].clone()
        return a

    def k15(label, args, want_overflow=None):
        got, want = pattern_emit(*fresh(args)), pattern_emit_ref(*fresh(args))
        torch.cuda.synchronize()
        same_bits(torch, list(got), list(want))
        if want_overflow is not None and bool(want[3]) != want_overflow:
            raise AssertionError(f"pattern_emit {label}: overflow {bool(want[3])}")
        print(f"kernel check pattern_emit {label}: T={args[0].T} C={args[3].shape[0]}, out_n "
              f"{int(args[7].item())} -> {int(want[2].item())}, overflow {bool(want[3])}: ok",
              flush=True)
        return args

    e_args = k15("P (purge)", k15_args(p2, PATTERN_C, MAIN_BATCH, 0.0, True))
    k15("overflowing buffer", k15_args(p2, PATTERN_C, MAIN_BATCH, 0.99, True),
        want_overflow=True)
    ce_args = k15("C", k15_args(cs_caps, COUNT_C, MAIN_BATCH, 0.0, False))
    k15("ragged", k15_args(small, 33, 64, 0.5, True))

    # times at the paths' shapes
    T, C = PATTERN_T, PATTERN_C
    r = res["pattern_advance"]
    r["ms"] = time_ms(torch, lambda: pattern_advance(*adv_p), 50)
    r["plain_ms"] = time_ms(torch, lambda: pattern_advance_ref(*adv_p), 10)
    _prog, p, tok, er, v, ts, _ev, cond, _o, _t = adv_p
    M = (tok["active"] & (tok["slot"] == p))[:, None] & v[None, :] & (
        torch.arange(C, device=dev)[None, :] > er[:, None]) & cond
    r["library_ms"] = time_ms(torch, lambda: torch.argmax(M.to(torch.int8), dim=1), 50)
    lane_b = 1 + 4 + 8 + 8 + 4 + 4  # active, slot, start, entry_ts, entry_row, n
    r["bound_ms"] = (T * (2 * lane_b + 4 + 2 * 4) + C * (1 + 8 + 1 + 4)) / MEM_BYTES_PER_S * 1e3
    r["bound_by"] = "bytes"
    r["other_shapes_ms"] = {
        "fork_slot0": time_ms(torch, lambda: pattern_advance(*fork_p), 50),
        "cross_ref_TxC": time_ms(torch, lambda: pattern_advance(*cross_p), 50)}

    r = res["pattern_count"]
    r["ms"] = time_ms(torch, lambda: pattern_count(*c_args), 50)
    r["plain_ms"] = time_ms(torch, lambda: pattern_count_ref(*c_args), 10)
    _prog, ctok, Mc, Madv, cts, _e0, _e1, _o = c_args
    mci = Mc.to(torch.int32)
    midx = torch.cumsum(mci, 0, dtype=torch.int32) - mci
    thresh = (2 - ctok["caps"][0]["n"].clamp(0, 2)).to(torch.int32)
    rows_c = torch.where(Madv, torch.arange(COUNT_C, device=dev, dtype=torch.int32), COUNT_C)
    r["library_ms"] = time_ms(torch, lambda: (torch.searchsorted(midx, thresh),
                                              torch.cummin(rows_c.flip(0), 0)), 50)
    Tc, Kc = COUNT_T, COUNT_K
    r["bound_ms"] = (COUNT_C * (1 + 1 + 8 + 4) + Tc * (2 * (1 + 4 + 8 + 8) + 4 + 2 * 2 * 4)
                     + Tc * 2 * 4) / MEM_BYTES_PER_S * 1e3
    r["bound_by"] = "bytes"
    r["T512_K4_capture_lanes"] = Kc

    # the buffer is written in place: each timed call starts again from
    # out_n = 0 (one memset more)
    r = res["pattern_emit"]
    ea = fresh(e_args)
    r["ms"] = time_ms(torch, lambda: (ea[7].zero_(), pattern_emit(*ea)), 50)
    r["plain_ms"] = time_ms(torch, lambda: (ea[7].zero_(), pattern_emit_ref(*ea)), 10)
    etok, eer = e_args[1], e_args[2]
    key = torch.where(etok["active"] & (etok["slot"] == 2), eer.to(torch.int64) * T +
                      torch.arange(T, device=dev), 1 << 60)
    r["library_ms"] = time_ms(torch, lambda: torch.argsort(key), 50)
    n_done = int((etok["active"] & (etok["slot"] == 2)).sum().item())
    row_b = 8 + 1 + 2 * (4 + 4)  # ts, valid, per ref n and symbol
    r["bound_ms"] = (T * (1 + 4 + 8 + 4 + 1) + C * (8 + 1) + n_done * 2 * row_b
                     ) / MEM_BYTES_PER_S * 1e3
    r["bound_by"] = "bytes"
    ca = fresh(ce_args)
    r["other_shapes_ms"] = {"C_shape_no_purge": time_ms(
        torch, lambda: (ca[7].zero_(), pattern_emit(*ca)), 50)}
    for name in names:
        r = res[name]
        print(f"kernel {name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) library_ms={r['library_ms']:.4f} "
              f"max_abs_err={r['max_abs_err']}", flush=True)
    print(f"kernel pattern_advance fork at P's shape: "
          f"{res['pattern_advance']['other_shapes_ms']['fork_slot0']:.4f} ms, cross-ref [T, C]: "
          f"{res['pattern_advance']['other_shapes_ms']['cross_ref_TxC']:.4f} ms; pattern_emit at "
          f"C's shape: {res['pattern_emit']['other_shapes_ms']['C_shape_no_purge']:.4f} ms",
          flush=True)
    return res


# the apps of tests/test_torch_pattern_scan.py: one per slot kind of the scan
SCAN_HEAD = ("define stream S (symbol string, price float, volume long);\n"
             "define stream S2 (symbol string, price double, volume int);\n")
SCAN_KIND_APPS = {
    "logical_and": "from every (e1=S[price > 50] and e2=S[volume > 500]) -> "
                   "e3=S[symbol == e1.symbol and price < e1.price - 30] within 2 sec "
                   "select e1.symbol as s, e1.price as p1, e2.volume as v2, e3.price as p3",
    "logical_or": "from e1=S[price > 70] or e2=S2[volume > 800] -> e3=S[price < 20] "
                  "select e1.price as p1, e2.volume as v2, e3.price as p3",
    "and_absent_wait": "from every e1=S[price > 60] and not S2[price > 80] for 100 milliseconds "
                       "-> e3=S[price < 10] select e1.price as p1, e3.price as p3",
    "or_absent_wait": "from e0=S[price > 90] -> e1=S[price > 60] or not S2[price > 80] "
                      "for 100 milliseconds select e0.price as p0, e1.price as p1",
    "both_absent_and_0": "from not S[price > 90] for 100 milliseconds and not S2[price > 90] "
                         "for 150 milliseconds -> e3=S[price < 10] select e3.price as p3",
    "both_absent_or_1": "from every e1=S[price > 80] -> not S[price < 5] for 100 milliseconds "
                        "or not S2[price < 5] for 120 milliseconds select e1.price as p1",
    "absent_for": "from every e1=S[price > 80] -> not S[symbol == e1.symbol and price < 10] "
                  "for 100 milliseconds select e1.symbol as s, e1.price as p",
    "absent_no_for": "from e1=S[price > 80] -> not S2[price < 20] and e3=S[price < 10] "
                     "select e1.price as p1, e3.price as p3",
    "every_absent": "from every not S2[price > 90] for 100 milliseconds -> e2=S[price < 20] "
                    "select e2.price as p2",
    "count_middle": "from e1=S[price > 80] -> e2=S[price < 30]<2:4> -> e3=S[price > 90] "
                    "select e1.price as p1, e2[0].price as q0, e2[last].price as ql, "
                    "e3.price as p3",
    "trailing_min0": "from every e1=S[price > 70] -> e2=S[volume > 900]<0:3> "
                     "select e1.price as p1, e2[0].volume as v0",
    "every_block": "from every (e1=S[price > 70] -> e2=S[price < 30]) "
                   "select e1.price as p1, e2.price as p2",
    "every_block_mid": "from e0=S[volume > 950] -> every (e1=S[price > 70] -> e2=S[price < 30]) "
                       "-> e3=S[volume < 50] select e0.volume as v0, e1.price as p1, "
                       "e3.volume as v3",
    "seq_count_fwd": "from every e1=S[price > 50]<1:3>, e2=S[price < 50] "
                     "select e1[0].price as a0, e1[last].price as al, e2.price as b",
    "seq_two_streams": "from every e1=S[price > 50], e2=S2[price < 40] within 1 sec "
                       "select e1.price as p1, e2.price as p2",
    "last_reads": "from every e1=S[price > 60]<2:5> -> "
                  "e2=S[price < e1[last].price - 30 and volume > e1[0].volume] "
                  "select e1[last].price as pl, e1[0].volume as v0, e2.price as p2",
    "cond_promote": "from every e1=S2[volume > 100] -> e2=S[(e1.volume + volume) / 2 > 500 and "
                    "price * 2 >= e1.price and volume % 7 != e1.volume % 5 and "
                    "not (e1.symbol is null)] select e1.volume as v1, e2.volume as v2",
    "cond_nulls": "from every e1=S2[volume > 0] -> e2=S[(volume - e1.volume) * 3 > e1.price / 2 "
                  "or e1.volume % 4 == volume % 4 or price / e1.volume <= 0.5 or "
                  "e1.volume / (e1.volume - e1.volume) == -1] "
                  "select e1.volume as v1, e2.volume as v2",
}


# K16's redesign traps: (label, app, T, stream, share of rows not
# quiet, ts step ms, ts disorder ms, exact live lanes or None)
SCAN_TRAP_APPS = {
    "hoisted_nulls": "from every e1=S[price > 60] -> e2=S[volume > 100 and symbol == e1.symbol "
                     "and price < e1.price and not (volume is null)] within 1 sec "
                     "select e1.price as p1, e2.price as p2, e2.volume as v2",
}
SCAN_TRAPS = [
    ("absent_for skipped stretches, deadlines inside", "absent_for", 64, "S", 0.03, 6, 0, None),
    ("both_absent_or_1 skipped stretches", "both_absent_or_1", 64, "S", 0.03, 6, 0, None),
    ("absent_for T=1024 skipped stretches", "absent_for", 1024, "S", 0.05, 4, 0, None),
    ("logical_and disordered ts across within kills", "logical_and", 64, "S", 0.05, 8, 1500,
     None),
    ("every_block disordered ts", "every_block", 64, "S", 0.05, 5, 300, None),
    ("seq_count_fwd long batch", "seq_count_fwd", 64, "S", 0.1, 3, 0, None),
    ("seq_two_streams long batch", "seq_two_streams", 64, "S", 0.1, 3, 0, None),
    ("logical_and T=1024 1 live lane", "logical_and", 1024, "S", 0.1, 4, 0, 1),
    ("logical_and T=1024 32 live lanes", "logical_and", 1024, "S", 0.1, 4, 0, 32),
    ("logical_and T=1024 33 live lanes", "logical_and", 1024, "S", 0.1, 4, 0, 33),
    ("logical_and T=1024 1024 live lanes", "logical_and", 1024, "S", 0.1, 4, 0, 1024),
    ("every_block T=1024 33 live lanes", "every_block", 1024, "S", 0.3, 2, 0, 33),
    ("hoisted conjuncts over nulls", "hoisted_nulls", 64, "S", 0.3, 5, 0, None),
]


def scan_step_bytes(prog, tok, batch, ev, rmask, regs, n_out) -> int:
    """Bytes one scan step must move: the token table read and written,
    the step's rows (ts, kind, valid, row masks, registers, the captured
    columns) read once, and the n_out emitted rows written."""
    lanes = [tok["active"], tok["slot"], tok["start_ts"], tok["entry_ts"]] + (
        [tok["fwd"]] if "fwd" in tok else [])
    lanes += [x for c in tok["caps"] for x in (c["n"], c["ts"], *c["cols"].values())]
    table = sum(x.numel() * x.element_size() for x in lanes)
    rows = (batch.ts.numel() * (8 + 1 + 1) + rmask.numel()
            + sum(r.numel() * r.element_size() for r in regs)
            + sum(v.numel() * v.element_size() for k, v in ev.items()
                  if any(k == name for _r, name in prog.cap_lanes())))
    keep_cols, ts_used = prog.capture_keep()
    row_out = 8 + 1 + 4 * len(prog.refs) + sum(
        (8 * a.cap if ts_used[a.ref_idx] else 0)
        + sum(c.element_size() * a.cap for c in tok["caps"][a.ref_idx]["cols"].values())
        for a in prog.refs)
    return 2 * table + rows + n_out * row_out


def scan_timing_inputs(torch, dev) -> dict:
    """K16's inputs at paths L's and A's data steps, as the kernel phase
    builds them: the first 32,768 rows of seed-7 stock data against each
    app's initial table. {"L"|"A": (call, args)}: call(args) runs one step
    on fresh emission lanes (`tools/redesign_times.py`)."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core.event import EventBatch
    from siddhi_tpu_torch.core.pattern import pattern_scan

    b = MAIN_BATCH
    d = stock_data(b, seed=7)
    sdata = EventBatch(
        ts=torch.from_numpy(d["ts"]).to(dev),
        kind=torch.zeros(b, dtype=torch.int8, device=dev),
        valid=torch.ones(b, dtype=torch.bool, device=dev),
        cols={k: torch.from_numpy(d[k]).to(dev) for k in ("symbol", "price", "volume")})
    out = {}
    for label, app in (("L", LOGICAL_APP), ("A", ABSENT_APP)):
        prog = SiddhiManager(device=dev).create_siddhi_app_runtime(
            app.format(batch=b)).queries["q"].prog
        prog.compile_scan()
        ev, rmask, regs = prog.scan_inputs("StockStream", sdata)
        args = [prog, prog.init_state(int(d["ts"][0])), "StockStream", sdata.ts, sdata.kind,
                sdata.valid, ev, rmask, regs, prog.init_out(b),
                torch.zeros((), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.bool, device=dev),
                torch.tensor(-(1 << 40), dtype=torch.int64, device=dev)]

        def call(a=args):
            a = list(a)
            a[9] = {k: v.clone() for k, v in a[9].items()}
            a[10] = a[10].clone()
            return pattern_scan(*a)

        out[label] = call
    return out


def pattern_scan_kernel_phase(torch, dev) -> dict:
    """K16 (the per-event scan) against its plain version on the card,
    exactly (every lane of the token table and the emission buffer, out_n
    and the overflow flag), from the same token tables and rows: at path L's
    shape (T=1024, one 32768-row batch of seed-7 stock data) and path A's
    (the same, and a one-row TIMER step after it); every app of
    tests/test_torch_pattern_scan.py (one per slot kind, a condition program
    with nulls and int/float promotion) from random token tables at T=64 and
    B=33, on each stream and a TIMER batch; T=33 with ragged B (33, 1000);
    lanes exhausted (a dense table); an emission buffer that overflows."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core.event import EventBatch
    from siddhi_tpu_torch.core.pattern import pattern_scan, pattern_scan_ref

    rng = np.random.default_rng(606)
    t0 = 1_700_000_000_000

    def prog_of(app):
        prog = SiddhiManager(device=dev).create_siddhi_app_runtime(app).queries["q"].prog
        prog.compile_scan()
        return prog

    def kind_app(name, T):
        return (f"@app:patternCapacity(size='{T}')\n" + SCAN_HEAD
                + f"@info(name='q') {SCAN_KIND_APPS[name]} insert into Out;")

    def column(name, dtype, shape):
        null = rng.random(shape) < 0.1
        if dtype == torch.float32:
            v = rng.uniform(0, 100, shape).astype(np.float32)
            sub = rng.random(shape) < 0.05  # compared and computed as zeros
            v[sub] = rng.choice(ARITH_TRAPS, int(sub.sum()))
            v[null] = np.nan
        elif name == "symbol":
            v = rng.integers(0, 5, shape).astype(np.int32)
        elif dtype == torch.int64:
            v = rng.integers(1, 1000, shape).astype(np.int64)
            v[null] = np.iinfo(np.int64).min
        else:
            v = rng.integers(1, 1000, shape).astype(np.int32)
            v[null] = np.iinfo(np.int32).min
        return torch.from_numpy(v).to(dev)

    def random_tok(prog, density):
        T, S = prog.T, len(prog.slots)
        tok = prog.init_state(t0)
        tok["active"] = torch.from_numpy(rng.random(T) < density).to(dev)
        tok["slot"] = torch.from_numpy(rng.integers(0, S, T).astype(np.int32)).to(dev)
        tok["start_ts"] = torch.from_numpy(np.where(
            rng.random(T) < 0.3, -1, t0 - rng.integers(0, 3000, T)).astype(np.int64)).to(dev)
        tok["entry_ts"] = torch.from_numpy((t0 - rng.integers(0, 400, T)).astype(np.int64)).to(dev)
        if "fwd" in tok:
            tok["fwd"] = torch.from_numpy(rng.random(T) < 0.3).to(dev)
        for a, c in zip(prog.refs, tok["caps"]):
            c["n"] = torch.from_numpy(rng.integers(0, a.cap + 2, T).astype(np.int32)).to(dev)
            c["ts"] = torch.from_numpy(t0 - rng.integers(0, 400, tuple(c["ts"].shape))).to(dev)
            for name, arr in list(c["cols"].items()):
                c["cols"][name] = column(name, arr.dtype, tuple(arr.shape))
        return tok

    def random_batch(prog, sid, B):
        ts = (t0 + np.cumsum(rng.integers(0, 60, B))).astype(np.int64)
        kind = np.where(rng.random(B) < 0.05, 2, 0).astype(np.int8)
        if sid is None:
            kind[:] = 2
        valid = rng.random(B) < 0.95
        cols = {}
        if sid is not None:
            for name, t in prog.schemas[sid].attrs:
                dtype = torch.float32 if t.name in ("FLOAT", "DOUBLE") else (
                    torch.int64 if t.name == "LONG" else torch.int32)
                cols[name] = column(name, dtype, (B,))
        return EventBatch(ts=torch.from_numpy(ts).to(dev), kind=torch.from_numpy(kind).to(dev),
                          valid=torch.from_numpy(valid).to(dev), cols=cols)

    def quiet_batch(prog, sid, B, hot, step, disorder):
        """random_batch's rows, most of them quiet (price 50 and volume 1,
        no row mask set, CURRENT), `hot` of them random; ts rising by 0..step
        ms, each moved by up to +-disorder ms."""
        b = random_batch(prog, sid, B)
        quiet = torch.from_numpy(rng.random(B) >= hot).to(dev)
        ts = t0 + np.cumsum(rng.integers(0, step + 1, B))
        if disorder:
            ts = ts + rng.integers(-disorder, disorder + 1, B)
        cols = dict(b.cols)
        for name, fill in (("price", 50), ("volume", 1)):
            if name in cols:
                cols[name] = torch.where(quiet, torch.full_like(cols[name], fill), cols[name])
        kind = torch.where(quiet, torch.zeros_like(b.kind), b.kind)
        return EventBatch(ts=torch.from_numpy(ts.astype(np.int64)).to(dev), kind=kind,
                          valid=b.valid, cols=cols)

    def args_of(prog, tok, sid, batch, cap=64, n0=0, seen=-(1 << 40)):
        ev, rmask, regs = prog.scan_inputs(sid, batch)
        return [prog, tok, sid, batch.ts, batch.kind, batch.valid, ev, rmask, regs,
                prog.init_out(cap), torch.full((), n0, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.bool, device=dev),
                torch.tensor(t0 + seen if seen > -(1 << 40) else seen, dtype=torch.int64,
                             device=dev)]

    def fresh(args):  # the emission buffer and out_n are written in place
        a = list(args)
        a[9] = {k: v.clone() for k, v in a[9].items()}
        a[10] = a[10].clone()
        return a

    checks = [0]
    plain_ms = {}

    def k16(label, args, want_overflow=None, quiet=False):
        got = pattern_scan(*fresh(args))
        torch.cuda.synchronize()
        t = time.perf_counter()
        want = pattern_scan_ref(*fresh(args))
        torch.cuda.synchronize()
        plain_ms[label] = (time.perf_counter() - t) * 1e3
        same_bits(torch, [got[0], got[1], got[2], got[3]], [want[0], want[1], want[2], want[3]])
        if want_overflow is not None and bool(want[3]) != want_overflow:
            raise AssertionError(f"pattern_scan {label}: overflow {bool(want[3])}")
        checks[0] += 1
        if not quiet:
            print(f"kernel check pattern_scan {label}: T={args[0].T} B={args[3].shape[0]}, "
                  f"out_n {int(args[10])} -> {int(want[2])}, overflow {bool(want[3])}: ok",
                  flush=True)
        return want

    # path L's and path A's shapes: the real rows of the first batch
    b = MAIN_BATCH
    d = stock_data(b, seed=7)
    sdata = EventBatch(
        ts=torch.from_numpy(d["ts"]).to(dev),
        kind=torch.zeros(b, dtype=torch.int8, device=dev),
        valid=torch.ones(b, dtype=torch.bool, device=dev),
        cols={k: torch.from_numpy(d[k]).to(dev) for k in ("symbol", "price", "volume")})
    lprog = prog_of(LOGICAL_APP.format(batch=b))
    l_args = args_of(lprog, lprog.init_state(int(d["ts"][0])), "StockStream", sdata, cap=b)
    l_want = k16(f"path L ({b} rows)", l_args)
    aprog = prog_of(ABSENT_APP.format(batch=b))
    a_args = args_of(aprog, aprog.init_state(int(d["ts"][0])), "StockStream", sdata, cap=b)
    a_want = k16(f"path A data step ({b} rows)", a_args)
    tb = EventBatch(ts=torch.full((1,), int(d["ts"][-1]) + 50, dtype=torch.int64, device=dev),
                    kind=torch.full((1,), 2, dtype=torch.int8, device=dev),
                    valid=torch.ones(1, dtype=torch.bool, device=dev), cols={})
    at_args = args_of(aprog, a_want[0], None, tb, cap=b)
    k16("path A TIMER step (1 row)", at_args)

    # every slot kind, from random tables, on each stream and a TIMER batch
    for name in SCAN_KIND_APPS:
        prog = prog_of(kind_app(name, 64))
        for sid in prog.stream_ids + [None]:
            for density, seen in ((0.5, -(1 << 40)), (0.9, 250)):
                k16(f"{name} {sid}", args_of(prog, random_tok(prog, density), sid,
                                             random_batch(prog, sid, 33), seen=seen), quiet=True)
    print(f"kernel check pattern_scan: {len(SCAN_KIND_APPS)} apps, one per slot kind, T=64 "
          f"B=33 ({checks[0] - 3} steps): ok", flush=True)
    for name in ("logical_and", "every_block", "seq_count_fwd", "absent_for"):
        prog = prog_of(kind_app(name, 33))
        for B in (33, 1000):
            k16(f"{name} T=33 ragged", args_of(prog, random_tok(prog, 0.5), prog.stream_ids[0],
                                               random_batch(prog, prog.stream_ids[0], B)))
    for name in ("every_absent", "logical_and", "every_block"):
        prog = prog_of(kind_app(name, 64))
        sid = prog.stream_ids[-1] if name == "every_absent" else prog.stream_ids[0]
        k16(f"{name} lanes exhausted", args_of(prog, random_tok(prog, 0.99), None if
                                               name == "every_absent" else sid,
                                               random_batch(prog, None if name == "every_absent"
                                                            else sid, 200), seen=2000),
            want_overflow=True)
    prog = prog_of(kind_app("absent_for", 64))
    k16("overflowing emission buffer", args_of(prog, random_tok(prog, 0.9), "S",
                                               random_batch(prog, "S", 200), cap=16, n0=10,
                                               seen=2000), want_overflow=True)
    n_before = checks[0]
    for label, name, T, sid, hot, step, disorder, live in SCAN_TRAPS:
        app = kind_app(name, T) if name in SCAN_KIND_APPS else (
            f"@app:patternCapacity(size='{T}')\n" + SCAN_HEAD
            + f"@info(name='q') {SCAN_TRAP_APPS[name]} insert into Out;")
        prog = prog_of(app)
        tok = random_tok(prog, 0.3)
        if live is not None:  # exactly `live` active lanes
            act = np.zeros(T, bool)
            act[rng.permutation(T)[:live]] = True
            tok["active"] = torch.from_numpy(act).to(dev)
        k16(label, args_of(prog, tok, sid, quiet_batch(prog, sid, 600, hot, step, disorder),
                           cap=256), quiet=True)
    print(f"kernel check pattern_scan: {checks[0] - n_before} redesign traps (skipped "
          f"stretches with deadlines inside, disordered ts across within kills, a sequence "
          f"and a fwd pattern, live counts 1/32/33/1024 at T=1024, hoisted conjuncts over "
          f"nulls): ok", flush=True)

    # times at the paths' shapes (the plain version's: its one run in the
    # check, a Python loop over the rows)
    res = {"max_abs_err": 0.0, "bound_by": "bytes", "library_ms": None}
    res["ms"] = time_ms(torch, lambda: pattern_scan(*fresh(l_args)), 5)
    res["plain_ms"] = plain_ms[f"path L ({b} rows)"]
    ev, rmask, regs = l_args[6:9]
    res["bound_ms"] = scan_step_bytes(lprog, l_args[1], sdata, ev, rmask, regs,
                                      int(l_want[2])) / MEM_BYTES_PER_S * 1e3
    a_ms = time_ms(torch, lambda: pattern_scan(*fresh(a_args)), 5)
    at_ms = time_ms(torch, lambda: pattern_scan(*fresh(at_args)), 50)
    a_plain = plain_ms[f"path A data step ({b} rows)"]
    ev, rmask, regs = a_args[6:9]
    a_bound = scan_step_bytes(aprog, a_args[1], sdata, ev, rmask, regs,
                              int(a_want[2])) / MEM_BYTES_PER_S * 1e3
    ev, rmask, regs = at_args[6:9]
    at_bound = scan_step_bytes(aprog, at_args[1], tb, ev, rmask, regs, 0) / MEM_BYTES_PER_S * 1e3
    res["path_A_shape"] = {"ms": a_ms, "plain_ms": a_plain, "bound_ms": a_bound,
                           "timer_step_ms": at_ms, "timer_step_bound_ms": at_bound}
    res["checks"] = checks[0]
    print(f"kernel pattern_scan: ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
          f"bound_ms={res['bound_ms']:.6f} (bytes) library_ms=none max_abs_err=0.0 at path L's "
          f"shape (T=1024, B=32768); path A's data step {a_ms:.4f} ms (plain {a_plain:.4f}, bound "
          f"{a_bound:.6f}), its one-row TIMER step {at_ms:.4f} ms (bound {at_bound:.6f})",
          flush=True)
    return {"pattern_scan": res}


# ---------------------------------------------------------------------------
# the tumbling time windows' and the remaining aggregators' kernels
# ---------------------------------------------------------------------------

TB_BATCH, TB_W, TB_T, TB_G = 32768, 1024, 1000, 1024  # B, time capacity, 1 sec, groups
# TB and PTB send 4 batches' worth of buckets (16 until the partitioned
# patterns' paths joined the script's time)
TB_BATCHES, XB_EVENTS, TB_CHECK_BATCH = 4, 1_000_000, 4096
TB_APP = """@app:playback @app:batch(size='{batch}')
define stream StockStream (symbol string, price float, volume long);
@info(name='q') from StockStream#window.timeBatch(1 sec)
select symbol, avg(price) as ap, stdDev(price) as sd, min(price) as lo, max(price) as hi,
       maxForever(price) as ath, distinctCount(volume) as dv, count() as n
group by symbol insert into Out;
"""
XB_APP = """@app:batch(size='{batch}')
define stream StockStream (symbol string, price float, volume long, ets long);
@info(name='q') from StockStream#window.externalTimeBatch(ets, 1 sec)
select avg(price) as ap, stdDev(price) as sd, max(price) as hi, minForever(price) as atl,
       distinctCount(symbol) as ds, count() as n
insert into Out;
"""
TB_KERNELS = ("time_batch_step", "assign_slots", "keyed_running_sum", "keep_last",
              "window_extreme_keyed", "keyed_running_extreme", "distinct_count")
XB_KERNELS = ("wire_decode", "time_batch_step", "running_sum", "window_extreme",
              "running_extreme", "distinct_count", "deliver_pack")


def time_batch_kernel_phase(torch, dev) -> dict:
    """The time-batch slice's kernels against their plain versions on the
    card, bit for bit, from the same inputs and state: the time-batch step
    (K17) at paths TB's and XB's shapes (B=32768, w=1024, 1 sec over 1 ms
    ticks: ~33 flushes a batch, EXPIRED lanes on, 3 carried steps) and a
    one-row TIMER step, ragged B=33 and B=4097 with holes and TIMER rows, an
    open bucket past w, an explicit start time, a gap of several empty
    buckets, a batch with no trigger row, and an idle timeout that is stale
    or elapsed at rank 0 and after a CURRENT row; the running extreme (K18)
    at B=32768 and 98,321 (past one tile) in float32/int32/int64, min and
    max, with resets and NaN rows, and over XB's flow; the keyed running extreme (K19) over a TB flow with G=1024, 8 and
    1,000 keys and 2,000 (overflowing the slot table); K3's key lane and the
    distinct count (K20) over TB's grouped flow and XB's ungrouped one, with
    NaN, null and int, float and string values."""
    from siddhi_tpu_torch.core.aggregators import (
        distinct_count,
        distinct_count_ref,
        window_extreme,
        window_extreme_ref,
    )
    from siddhi_tpu_torch.core.event import EventBatch, StreamSchema
    from siddhi_tpu_torch.core.types import AttrType
    from siddhi_tpu_torch.core.windows import (
        TIMER_BUCKET,
        TIMER_NONE,
        TIMER_TIMEOUT,
        BatchWindow,
        time_batch_step,
        time_batch_step_ref,
    )
    from siddhi_tpu_torch.ops.group import (
        assign_slots_ref,
        keyed_running_extreme,
        keyed_running_extreme_ref,
    )
    from siddhi_tpu_torch.ops.prefix import running_extreme, running_extreme_ref

    schema = StreamSchema("StockStream", [("symbol", AttrType.STRING), ("price", AttrType.FLOAT),
                                          ("volume", AttrType.LONG), ("ets", AttrType.LONG)])
    names = ("time_batch_step", "running_extreme", "keyed_running_extreme",
             "window_extreme_keyed", "distinct_count")
    res = {k: {"max_abs_err": 0.0, "checks": 0} for k in names}
    rng = np.random.default_rng(707)
    col_bytes = 4 + 4 + 8 + 8
    nan = float("nan")
    long_null = -(1 << 63)

    def exact(name, got, want):
        torch.cuda.synchronize()
        if name in ("running_extreme", "keyed_running_extreme", "window_extreme_keyed"):
            # min/max may keep either NaN: NaN in the same places, the rest equal
            for g, w in zip(flat(got), flat(want), strict=True):
                if g.dtype != w.dtype or g.shape != w.shape:
                    raise AssertionError(f"{name}: dtype/shape differ")
                gn, wn = (torch.isnan(x) if x.dtype.is_floating_point else torch.zeros_like(
                    x, dtype=torch.bool) for x in (g, w))
                if not torch.equal(gn, wn) or not torch.equal(g[~gn], w[~wn]):
                    raise AssertionError(f"{name}: not exact")
        else:
            same_bits(torch, got, want)
        res[name]["checks"] += 1

    def make_batch(b, clock, ragged=False, gap=0, no_trigger=False, timer_first=False,
                   ext_timers=False):
        d = stock_data(b, seed=int(rng.integers(1 << 30)))
        step = rng.integers(0, 3, b) if ragged else np.ones(b, np.int64)
        ts = clock + np.cumsum(step).astype(np.int64) + gap
        kind = np.zeros(b, np.int8)
        valid = np.ones(b, bool)
        if ragged:
            valid &= rng.random(b) < 0.9
            kind[rng.random(b) < 0.05] = 2
        if timer_first:
            kind[0], valid[0] = 2, True
        if no_trigger:
            valid[:] = False
        ets = ts.copy()
        if ext_timers:
            ets[kind == 2] = long_null  # a TIMER row's null payload
        price = arith_traps(rng, d["price"]) if ragged else d["price"]  # subnormal operands
        cols = {"symbol": d["symbol"], "price": price, "volume": d["volume"], "ets": ets}
        return EventBatch(ts=torch.from_numpy(ts).to(dev), kind=torch.from_numpy(kind).to(dev),
                          valid=torch.from_numpy(valid).to(dev),
                          cols={n: torch.from_numpy(v).to(dev) for n, v in cols.items()})

    def timer_batch(t_ms):
        one = dict(dtype=torch.int64, device=dev)
        return EventBatch(ts=torch.full((1,), t_ms, **one),
                          kind=torch.full((1,), 2, dtype=torch.int8, device=dev),
                          valid=torch.ones(1, dtype=torch.bool, device=dev),
                          cols={"symbol": torch.zeros(1, dtype=torch.int32, device=dev),
                                "price": torch.full((1,), nan, device=dev),
                                "volume": torch.full((1,), long_null, **one),
                                "ets": torch.full((1,), long_null, **one)})

    def k17(state, batch, now, w, t, start, timeout, mode, exp, ext):
        wts = batch.cols["ets"] if ext else batch.ts
        now_t = torch.tensor(now, dtype=torch.int64, device=dev)
        args = (state, batch, wts, now_t, w, t, start, timeout, mode, exp)
        got, want = time_batch_step(*args), time_batch_step_ref(*args)

        def flat(r):
            return [r[0].ts, r[0].kind, r[0].valid, r[0].cols, r[1] if exp else [],
                    r[2] if exp else [], r[3], r[4]]

        exact("time_batch_step", flat(got), flat(want))
        return want, args

    main = {}
    # (label, B, w, t, start, timeout, mode, ext, steps, batch options)
    cases = [
        ("TB", TB_BATCH, TB_W, TB_T, None, None, TIMER_BUCKET, False, 3, {}),
        ("XB", TB_BATCH, TB_W, TB_T, None, None, TIMER_NONE, True, 3, {}),
        ("B=33 ragged", 33, 16, 10, None, None, TIMER_BUCKET, False, 4, {"ragged": True}),
        ("B=4097 ragged", 4097, TB_W, 100, None, None, TIMER_BUCKET, False, 3,
         {"ragged": True}),
        ("past w", 4097, TB_W, 10_000, None, None, TIMER_NONE, True, 2, {}),
        ("start time", 4097, TB_W, TB_T, 1_700_000_000_123, None, TIMER_NONE, True, 3, {}),
        ("empty buckets", 4097, TB_W, 100, None, None, TIMER_BUCKET, False, 3,
         {"gap": 730}),
        ("no trigger", 33, 16, 10, None, None, TIMER_BUCKET, False, 2, {"no_trigger": True}),
    ]
    for label, b, w, t, start, timeout, mode, ext, steps, opts in cases:
        state = BatchWindow(schema, "StockStream", None, dev, capacity=w, duration_ms=t,
                            time_attr="ets" if ext else None, start_time=start,
                            timeout_ms=timeout).init_state()
        clock, flushes = 1_700_000_000_000, 0
        for step in range(steps):
            batch = make_batch(b, clock, **opts)
            clock = int(batch.ts[-1]) + 1
            want, args = k17(state, batch, clock, w, t, start, timeout, mode, True, ext)
            if label in ("TB", "XB") and step == steps - 1:
                main[label] = dict(args=args, rows=want[0].valid.shape[0])
            flushes += int((want[0].kind == 3).sum())
            state = want[3]
            if mode == TIMER_BUCKET:  # the TIMER step at the open bucket's end
                want, _ = k17(state, timer_batch(int(want[4])), int(want[4]), w, t, start,
                              timeout, mode, True, ext)
                flushes += int((want[0].kind == 3).sum())
                state = want[3]
        print(f"kernel check time batch {label}: B={b} w={w} t={t} {steps} steps, "
              f"{flushes} flushes ok", flush=True)
    # the idle timeout: stale and elapsed TIMERs, at rank 0 and after a
    # CURRENT row (the deadline is wall-clock: `now` is set around it)
    state = BatchWindow(schema, "StockStream", None, dev, capacity=TB_W, duration_ms=TB_T,
                        time_attr="ets", timeout_ms=500).init_state()
    clock, now, forced = 1_700_000_000_000, 5_000, 0
    for step, (dnow, timer_first) in enumerate(((0, False), (-100, True), (100, True),
                                                (100, False), (100, True))):
        batch = make_batch(4097, clock, ragged=True, timer_first=timer_first, ext_timers=True)
        clock = int(batch.ts[-1]) + 1
        dl = int(state["timeout_deadline"])
        now = (dl + dnow) if dl < (1 << 62) else now + 10
        want, _ = k17(state, batch, now, TB_W, TB_T, None, 500, TIMER_TIMEOUT, True, True)
        forced += int((want[0].kind == 3).sum())
        state = want[3]
        dl = int(state["timeout_deadline"])
        for dt in (-50, 50):  # one-row TIMER steps, stale then elapsed
            want, _ = k17(state, timer_batch(dl + dt), dl + dt, TB_W, TB_T, None, 500,
                          TIMER_TIMEOUT, True, True)
            forced += int((want[0].kind == 3).sum())
            state = want[3]
    print(f"kernel check time batch idle timeout: {forced} flushes ok", flush=True)

    # K18 at B=32768 (one 32768-row tile) and past one tile (3 tiles and a
    # ragged fourth: the tile aggregates and the carry across tiles); over
    # XB's own flow below
    for dtype, n in itertools.product((torch.float32, torch.int32, torch.int64),
                                      (TB_BATCH, 3 * TB_BATCH + 17)):
        for is_min in (True, False):
            if dtype.is_floating_point:
                vals = torch.from_numpy(rng.uniform(-100, 100, n).astype(np.float32))
                vals[rng.random(n) < 0.001] = nan
            else:
                vals = torch.from_numpy(rng.integers(-10**6, 10**6, n)).to(dtype)
            active = torch.from_numpy(rng.random(n) < 0.8)
            reset = torch.from_numpy(rng.random(n) < 0.001) & ~active
            base = vals[:1].clone().reshape(())
            a = [x.to(dev) for x in (vals, active, reset, base)]
            exact("running_extreme", list(running_extreme(*a, is_min)),
                  list(running_extreme_ref(*a, is_min)))
    print(f"kernel check running_extreme: float32/int32/int64 x min/max at B={TB_BATCH} and "
          f"{3 * TB_BATCH + 17} ok", flush=True)

    # the aggregators over TB's and XB's flows (from the last checked step)
    def flow_of(label):
        a = main[label]["args"]
        state, batch = a[0], a[1]
        out, birth, death, _, _ = time_batch_step_ref(*a)
        elems = {c: torch.cat([state["cur_cols"][c], state["prev_cols"][c], batch.cols[c]])
                 for c in batch.cols}
        return out, birth, death, elems

    tb_out, tb_birth, tb_death, tb_elems = flow_of("TB")
    rows = tb_out.valid.shape[0]
    cur = tb_out.valid & (tb_out.kind == 0)
    exp = tb_out.valid & (tb_out.kind == 1)
    reset = tb_out.valid & (tb_out.kind == 3)
    sign_active = cur | exp
    key_cases = {}
    # 8 symbols and 1,000 keys over the flow's buckets (resets between
    # them); 2,000 keys with no reset overflow the slot table
    for n_keys in (8, 1000, 2000):
        sym = tb_out.cols["symbol"].to(torch.int64)
        keys = sym if n_keys == 8 else torch.from_numpy(
            rng.integers(0, n_keys, rows)).to(dev)
        rs = reset if n_keys <= TB_G else torch.zeros_like(reset)
        table = (torch.zeros(TB_G, dtype=torch.int64, device=dev),
                 torch.zeros(TB_G, dtype=torch.bool, device=dev),
                 torch.zeros((), dtype=torch.int32, device=dev))
        _, _, _, slot, grp, over = assign_slots_ref(*table, keys, sign_active, rs)
        if bool(over) != (n_keys > TB_G):
            raise AssertionError(f"{n_keys} keys at G={TB_G}: overflow flag {bool(over)}")
        key_cases[n_keys] = (slot, grp)
        for vals in (tb_out.cols["price"], tb_out.cols["volume"], tb_out.cols["symbol"]):
            carry = vals[:TB_G].clone()
            # the running form, and the forever form (resets zeroed over
            # segments that split at them: a slot may end several)
            for is_min, ext_reset in ((True, rs), (False, rs), (False, torch.zeros_like(rs))):
                a = (vals.contiguous(), cur, grp, ext_reset, carry, slot, is_min)
                exact("keyed_running_extreme", list(keyed_running_extreme(*a)),
                      list(keyed_running_extreme_ref(*a)))
    print(f"kernel check keyed_running_extreme: {rows} flow rows, G={TB_G}, 8/1000/2000 keys "
          "ok", flush=True)

    ekey = tb_elems["symbol"].to(torch.int64).contiguous()
    rkey = tb_out.cols["symbol"].to(torch.int64).contiguous()
    for is_min in (True, False):
        a = (tb_elems["price"].contiguous(), tb_birth, tb_death, rows, is_min, AttrType.FLOAT,
             ekey, rkey)
        exact("window_extreme_keyed", window_extreme(*a), window_extreme_ref(*a))
    print(f"kernel check window_extreme keyed: {rows} rows x {ekey.shape[0]} elements ok",
          flush=True)

    xb_out, xb_birth, xb_death, xb_elems = flow_of("XB")
    xrows = xb_out.valid.shape[0]
    # K18 over XB's flow rows (3w + 3B, four tiles): the path's minForever
    # (resets zeroed) from the identity and from a carried value, and the
    # running forms with the flow's RESET rows
    xvals = xb_out.cols["price"].contiguous()
    xcur = xb_out.valid & (xb_out.kind == 0)
    xreset = torch.zeros_like(xcur)  # minForever: resets zeroed
    xbase = torch.tensor(float("inf"), device=dev)
    xflow_reset = xb_out.valid & (xb_out.kind == 3)
    carried = torch.tensor(37.5, device=dev)
    for rs, base, is_min in ((xreset, xbase, True), (xreset, carried, True),
                             (xflow_reset, carried, True), (xflow_reset, -xbase, False)):
        a = (xvals, xcur, rs, base)
        exact("running_extreme", list(running_extreme(*a, is_min)),
              list(running_extreme_ref(*a, is_min)))
    print(f"kernel check running_extreme: XB's {xrows} flow rows, forever and running ok",
          flush=True)
    price_nan = tb_elems["price"].clone()
    price_nan[::97] = nan
    vol_null = tb_elems["volume"].clone()
    vol_null[::89] = long_null
    for label, vals, b, d, r, keys in (
            ("TB volume grouped", tb_elems["volume"], tb_birth, tb_death, rows, (ekey, rkey)),
            ("TB price NaN grouped", price_nan, tb_birth, tb_death, rows, (ekey, rkey)),
            ("TB volume null", vol_null, tb_birth, tb_death, rows, (None, None)),
            ("XB symbol", xb_elems["symbol"], xb_birth, xb_death, xrows, (None, None)),
            ("XB price", xb_elems["price"], xb_birth, xb_death, xrows, (None, None))):
        a = (vals.contiguous(), b, d, r, *keys)
        exact("distinct_count", distinct_count(*a), distinct_count_ref(*a))
    print("kernel check distinct_count: TB grouped and XB ungrouped, int/float/string, NaN "
          "and null ok", flush=True)

    # times at the paths' shapes
    r17 = res["time_batch_step"]
    targs = main["TB"]["args"]
    r17["ms"] = time_ms(torch, lambda: time_batch_step(*targs), 20)
    r17["plain_ms"] = time_ms(torch, lambda: time_batch_step_ref(*targs), 5)
    r17["library_ms"] = None
    k17_bytes = (TB_BATCH * (8 + 8 + 1 + 1 + col_bytes) + 2 * TB_W * (col_bytes + 8) + 64
                 + rows * (8 + 1 + 1 + col_bytes) + 2 * (2 * TB_W + TB_BATCH) * 4
                 + 2 * TB_W * (col_bytes + 8) + 64)
    r17["bound_ms"], r17["bound_by"] = k17_bytes / MEM_BYTES_PER_S * 1e3, "bytes"
    r17["XB_ms"] = time_ms(torch, lambda: time_batch_step(*main["XB"]["args"]), 20)

    r18 = res["running_extreme"]
    r18["ms"] = time_ms(torch, lambda: running_extreme(xvals, xcur, xreset, xbase, True), 50)
    r18["plain_ms"] = time_ms(
        torch, lambda: running_extreme_ref(xvals, xcur, xreset, xbase, True), 10)
    masked = torch.where(xcur, xvals, xbase)
    r18["library_ms"] = time_ms(torch, lambda: torch.cummin(masked, 0), 50)
    r18["library"] = "torch.cummin (no resets, inactive rows pre-masked)"
    r18["bound_ms"], r18["bound_by"] = max(
        (xrows * (4 + 1 + 1 + 4) / MEM_BYTES_PER_S * 1e3, "bytes"),
        (xrows / FP32_OPS_PER_S * 1e3, "operations"))

    r19 = res["keyed_running_extreme"]
    slot, grp = key_cases[8]
    price = tb_out.cols["price"].contiguous()
    carry = torch.full((TB_G,), -float("inf"), device=dev)
    zero_reset = torch.zeros_like(reset)  # maxForever: resets zeroed
    r19["ms"] = time_ms(
        torch, lambda: keyed_running_extreme(price, cur, grp, zero_reset, carry, slot, False), 50)
    r19["plain_ms"] = time_ms(
        torch, lambda: keyed_running_extreme_ref(price, cur, grp, zero_reset, carry, slot, False),
        10)
    r19["library_ms"] = None
    r19["bound_ms"], r19["bound_by"] = max(
        ((rows * (4 + 1 + 4 + 4 + 4) + 8 + 2 * TB_G * 4) / MEM_BYTES_PER_S * 1e3, "bytes"),
        (rows / FP32_OPS_PER_S * 1e3, "operations"))

    def keyed_pairs(birth, death, ek, rk, n_rows):
        """(element, row) pairs the data needs: rows in [birth, death) with
        the element's key."""
        total = 0
        for k in torch.unique(ek).tolist():
            cnt = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                             torch.cumsum((rk == k).to(torch.int64), 0)])
            sel = (ek == k) & (birth < death)
            lo = birth[sel].clamp(0, n_rows).long()
            hi = death[sel].clamp(0, n_rows).long()
            total += int((cnt[hi] - cnt[lo]).clamp(min=0).sum())
        return total

    r3 = res["window_extreme_keyed"]
    pvals = tb_elems["price"].contiguous()
    r3["ms"] = time_ms(torch, lambda: window_extreme(
        pvals, tb_birth, tb_death, rows, True, AttrType.FLOAT, ekey, rkey), 10)
    r3["plain_ms"] = time_ms(torch, lambda: window_extreme_ref(
        pvals, tb_birth, tb_death, rows, True, AttrType.FLOAT, ekey, rkey), 2)
    r3["library_ms"] = None
    k_el = pvals.shape[0]
    r3["pairs"] = keyed_pairs(tb_birth, tb_death, ekey, rkey, rows)
    r3["bound_ms"], r3["bound_by"] = max(
        ((k_el * (4 + 4 + 4 + 8) + rows * 8 + rows * 4) / MEM_BYTES_PER_S * 1e3, "bytes"),
        (r3["pairs"] / FP32_OPS_PER_S * 1e3, "operations"))

    r20 = res["distinct_count"]
    vvals = tb_elems["volume"].contiguous()
    r20["ms"] = time_ms(torch, lambda: distinct_count(vvals, tb_birth, tb_death, rows, ekey,
                                                      rkey), 10)
    r20["plain_ms"] = time_ms(torch, lambda: distinct_count_ref(vvals, tb_birth, tb_death, rows,
                                                                ekey, rkey), 5)
    r20["library_ms"] = None
    r20["bound_ms"], r20["bound_by"] = (
        (k_el * (8 + 4 + 4 + 8) + rows * 8 + rows * 8) / MEM_BYTES_PER_S * 1e3, "bytes")
    r20["XB_ms"] = time_ms(torch, lambda: distinct_count(
        xb_elems["symbol"].contiguous(), xb_birth, xb_death, xrows), 10)
    for name in names:
        r = res[name]
        lib = "None" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"kernel {name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) library_ms={lib} "
              f"checks={r['checks']} exact", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 2, the table slice: K21-K24 against their plain versions
# ---------------------------------------------------------------------------

TAB_PK_ROWS, TAB_ROWS, TAB_JOIN_ROWS, TAB_BATCH = 1_000_000, 100_000, 16_384, 8192
LONG_NULL = -(1 << 63)


def time_once(torch, fn) -> float:
    """Wall time of one call on the device, from CUDA events (for the slow
    plain versions of K21 and K24, which loop on the host)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def table_kernel_phase(torch, dev, index_only: bool = False) -> dict:
    """The table slice's kernels against their plain versions on the card,
    bit for bit, from the same inputs and state: the insert (K21) at path
    TAB-PK's load (C=1,000,000 half full, B=8192, the key's sorted index)
    and TAB-UPSERT's (C=100,000, no index: the table scan), with keys new,
    stored, repeated within the batch and null, then ragged B 1/33/4097 and
    C 33/4097, a full table (overflow), a two-column key and no key; the
    index build and probe (K22) at TAB-PK's shape (1,000,000 keys, 8192
    probes with repeats, nulls and misses), float keys with NaN, -0.0 and
    +inf, int keys with nulls, a table holding duplicates (ix_dups), float
    probes of long keys, ragged sizes; the condition match (K23) at
    TAB-DENSE's shape (B=8192, C=100,000, `T.k >= k and T.k < k + 8`, writer
    and delete) and TAB-JOIN's (B=8192, C=16,384, `T.k == k`, per row), with
    nulls, ragged, its device gate off and on; the sequential routines (K24)
    at TAB-UPSERT's shape
    (B=8192, C=100,000 half full, keys from [0, 150,000)), a full table, the
    rekey guard (a rekey onto a live key, two rekeys in one event, a clean
    rekey) and the unguarded update with a table-dependent set value. K22
    also at the radix sort's tile edges and above (C 1,023/1,024/1,025/
    2,047/2,048/2,049/4,097/131,073/10^6), with keys varying in every byte
    and an all-empty table, and two probe calls in a row (the cached writer
    scratch all -1 after them); its ms the whole call and device_ms its
    kernels alone (`device_all_ms`), beside the library call's library_ms
    and library_device_ms measured alike. index_only: K22 alone
    (`--sorts`), with its and the library call's kernel times summed by
    torch.profiler (kernel_ms, library_kernel_ms)."""
    from siddhi_tpu_torch.compiler.siddhi_compiler import SiddhiCompiler
    from siddhi_tpu_torch.core.event import StreamSchema
    from siddhi_tpu_torch.core.executor import TS_ATTR, Env
    from siddhi_tpu_torch.core.pattern import OP_CONST, OP_REG
    from siddhi_tpu_torch.core.table import (
        InMemoryTable,
        eval_regs,
        build_scan_programs,
        emit_program,
        output_scope,
    )
    from siddhi_tpu_torch.core.types import AttrType, InternTable
    from siddhi_tpu_torch.ops import table as K
    from siddhi_tpu_torch.query_api.execution import UpdateSetAttribute
    from siddhi_tpu_torch.query_api.expression import Variable

    names = ("table_write", "table_index_build", "table_index_probe", "table_match",
             "table_scan")
    res = {k: {"max_abs_err": 0.0, "checks": 0} for k in names}
    rng = np.random.default_rng(808)
    interner = InternTable()
    out_schema = StreamSchema("__out__", [("k", AttrType.LONG), ("v", AttrType.LONG)])

    def make_table(pk: str = "", index: str = "", c: int = 64, cols="k long, v long"):
        app = SiddhiCompiler.parse(f"{pk} {index} define table T ({cols});")
        return InMemoryTable(app.table_definitions["T"], interner, dev, capacity=c)

    def exact(name, got, want):
        torch.cuda.synchronize()
        same_bits(torch, got, want)
        res[name]["checks"] += 1

    def fill_state(t, n_valid: int, keys=None, holes=True):
        """t's state with n_valid valid slots (scattered when holes), keys
        0.. or `keys`, v = the key times 10, seq a permutation, indexes
        built by the plain version."""
        c = t.capacity
        st = t.init_state()
        pos = rng.permutation(c)[:n_valid] if holes else np.arange(n_valid)
        valid = np.zeros(c, bool)
        valid[pos] = True
        k = np.asarray(keys if keys is not None else np.arange(n_valid), np.int64)
        kcol = np.zeros(c, np.int64)
        kcol[pos] = k
        kcol[~valid] = rng.integers(0, 1 << 40, int((~valid).sum()))  # stale values
        st["cols"]["k"] = torch.from_numpy(kcol).to(dev)
        if "v" in st["cols"]:
            st["cols"]["v"] = torch.from_numpy(kcol * 10).to(dev)
        seq = np.full(c, np.iinfo(np.int64).max, np.int64)
        seq[pos] = rng.permutation(n_valid)
        st["ts"] = torch.from_numpy(np.arange(c, dtype=np.int64) + 1_700_000_000_000).to(dev)
        st["valid"] = torch.from_numpy(valid).to(dev)
        st["seq"] = torch.from_numpy(seq).to(dev)
        st["next"] = torch.tensor(n_valid, dtype=torch.int64, device=dev)
        for col in t._indexed_cols:
            o, s, d = K.table_index_build_ref(st["cols"][col], st["valid"])
            st.update({f"ix_order.{col}": o, f"ix_sorted.{col}": s, f"ix_dups.{col}": d})
        return st

    def batch_cols(b, lo, hi, nulls=0.05, dup=0.1):
        k = rng.integers(lo, hi, b).astype(np.int64)
        rep = rng.random(b) < dup
        k[rep] = k[rng.integers(0, b, b)][rep]
        k[rng.random(b) < nulls] = LONG_NULL
        cols = {"k": torch.from_numpy(k).to(dev),
                "v": torch.from_numpy(np.arange(b, dtype=np.int64)).to(dev)}
        rows = torch.from_numpy(rng.random(b) < 0.95).to(dev)
        ts = torch.from_numpy(np.arange(b, dtype=np.int64) + 1_800_000_000_000).to(dev)
        return cols, ts, rows

    # ---- K21: the insert --------------------------------------------------
    def write_case(t, st, b, lo, hi, **kw):
        cols, ts, rows = batch_cols(b, lo, hi, **kw)
        index = None
        if len(t.primary_keys) == 1 and t.primary_keys[0] in t._indexed_cols:
            col = t.primary_keys[0]
            index = (st[f"ix_order.{col}"], st[f"ix_sorted.{col}"])
        got = K.table_write(st, cols, ts, rows, t.primary_keys, index)
        want = K.table_write_ref(st, cols, ts, rows, t.primary_keys)
        exact("table_write", got, want)
        return st, cols, ts, rows, index

    t_pk = make_table("@PrimaryKey('k')", "@Index('k')", TAB_PK_ROWS)
    st_pk = fill_state(t_pk, TAB_PK_ROWS // 2)
    if index_only:
        w_rows = batch_cols(TAB_BATCH, TAB_PK_ROWS // 4, TAB_PK_ROWS)[2]
    else:
        _st, w_cols, w_ts, w_rows, w_index = write_case(t_pk, st_pk, TAB_BATCH, TAB_PK_ROWS // 4,
                                                        TAB_PK_ROWS)
        r21 = res["table_write"]
        r21["ms"] = time_ms(
            torch, lambda: K.table_write(st_pk, w_cols, w_ts, w_rows, ["k"], w_index), 10)
        r21["plain_ms"] = time_once(torch, lambda: K.table_write_ref(st_pk, w_cols, w_ts, w_rows,
                                                                     ["k"]))
        r21["library_ms"] = None
        # the rows' lanes and key search (log2 C probes of the sorted keys, then
        # the found slot's ix_order once), the occupancy read, the kept rows'
        # lanes written with valid and seq
        probes = TAB_BATCH * (int(np.ceil(np.log2(TAB_PK_ROWS))) * 8 + 4)
        r21["bound_ms"], r21["bound_by"] = (
            (TAB_BATCH * (8 + 8 + 8 + 1) + probes + TAB_PK_ROWS + TAB_BATCH * (8 + 8 + 8 + 8 + 1))
            / MEM_BYTES_PER_S * 1e3, "bytes")
        t_up = make_table("@PrimaryKey('k')", "", TAB_ROWS)
        st_up = fill_state(t_up, TAB_ROWS // 2)
        _st, u_cols, u_ts, u_rows, _ix = write_case(t_up, st_up, TAB_BATCH, 0, 3 * TAB_ROWS // 2)
        r21["scan_ms"] = time_ms(
            torch, lambda: K.table_write(st_up, u_cols, u_ts, u_rows, ["k"]), 5)
        for b, c, n in ((1, 33, 10), (33, 33, 20), (4097, 4097, 2000), (33, 4097, 4097),
                        (8, 33, 30), (4097, 33, 0)):
            for pk, ix in (("@PrimaryKey('k')", "@Index('k')"), ("@PrimaryKey('k')", ""),
                           ("@PrimaryKey('k','v')", ""), ("", "")):
                t = make_table(pk, ix, c)
                write_case(t, fill_state(t, n), b, 0, 2 * max(n, 1), nulls=0.1, dup=0.3)

    # ---- K22: the sorted index and its probe ------------------------------
    r22, r22p = res["table_index_build"], res["table_index_probe"]
    keys, valid = st_pk["cols"]["k"], st_pk["valid"]
    exact("table_index_build", K.table_index_build(keys, valid),
          K.table_index_build_ref(keys, valid))
    r22["ms"] = time_ms(torch, lambda: K.table_index_build(keys, valid), 10)
    r22["device_ms"] = device_all_ms(torch, lambda: K.table_index_build(keys, valid), 10)
    r22["plain_ms"] = time_ms(torch, lambda: K.table_index_build_ref(keys, valid), 5)
    r22["library_ms"] = time_ms(torch, lambda: torch.sort(keys, stable=True), 10)
    r22["library_device_ms"] = device_all_ms(torch, lambda: torch.sort(keys, stable=True), 10)
    # the same table with its empty slots' stale keys inside the live keys'
    # range (as TAB-PK's own table: three key bytes and the empty flag vary)
    in_range = torch.where(valid, keys, torch.remainder(keys, TAB_PK_ROWS))
    r22["in_range_device_ms"] = device_all_ms(
        torch, lambda: K.table_index_build(in_range, valid), 10)
    r22["in_range_library_device_ms"] = device_all_ms(
        torch, lambda: torch.sort(in_range, stable=True), 10)
    exact("table_index_build", K.table_index_build(in_range, valid),
          K.table_index_build_ref(in_range, valid))
    r22["bound_ms"], r22["bound_by"] = (TAB_PK_ROWS * (8 + 1 + 4 + 8) / MEM_BYTES_PER_S * 1e3,
                                        "bytes")
    for c in (1, 33, 4097, 70_000):
        fk = rng.uniform(-5, 5, c).astype(np.float32).round()
        fk[rng.random(c) < 0.1] = np.nan
        fk[rng.random(c) < 0.05] = -0.0
        fk[rng.random(c) < 0.05] = np.inf
        sub = rng.random(c) < 0.1
        fk[sub] = rng.choice(SUBNORMALS, int(sub.sum()))
        ik = rng.integers(-3, 3, c).astype(np.int32)
        ik[rng.random(c) < 0.1] = np.iinfo(np.int32).min
        lk = rng.integers(-(1 << 62), 1 << 62, c).astype(np.int64)
        lk[rng.random(c) < 0.1] = LONG_NULL
        vm = torch.from_numpy(rng.random(c) < 0.7).to(dev)
        for arr in (fk, ik, lk, np.unique(lk)[: c] if c > 1 else lk):
            kk = torch.from_numpy(np.resize(arr, c)).to(dev)
            exact("table_index_build", K.table_index_build(kk, vm), K.table_index_build_ref(kk, vm))

    def probe_case(keys, valid, probe_raw, ok):
        order, sk, _d = K.table_index_build_ref(keys, valid)
        exact("table_index_probe",
              K.table_index_probe(keys, valid, order, sk, probe_raw, ok,
                                  K.winner_scratch(dev, keys.shape[0])),
              K.table_index_probe_ref(keys, valid, order, sk, probe_raw, ok))
        return order, sk

    pk_probe = torch.from_numpy(rng.integers(0, TAB_PK_ROWS, TAB_BATCH).astype(np.int64)).to(dev)
    pk_probe[::97] = LONG_NULL
    ok = w_rows & (pk_probe != LONG_NULL)
    order, sk = probe_case(keys, valid, pk_probe, ok)
    pk_winner = K.winner_scratch(dev, TAB_PK_ROWS)  # the index's own, as a table keeps it

    def probe_call():
        return K.table_index_probe(keys, valid, order, sk, pk_probe, ok, pk_winner)

    r22p["ms"] = time_ms(torch, probe_call, 10)
    r22p["device_ms"] = device_all_ms(torch, probe_call, 10)
    r22p["plain_ms"] = time_ms(torch, lambda: K.table_index_probe_ref(keys, valid, order, sk,
                                                                      pk_probe, ok), 5)
    r22p["library_ms"] = time_ms(torch, lambda: torch.searchsorted(sk, pk_probe), 10)
    r22p["library_device_ms"] = device_all_ms(torch, lambda: torch.searchsorted(sk, pk_probe), 10)
    if index_only:  # the kernel times summed by torch.profiler as well
        for row, call, lib in ((r22, lambda: K.table_index_build(keys, valid),
                                lambda: torch.sort(keys, stable=True)),
                               (r22p, probe_call, lambda: torch.searchsorted(sk, pk_probe))):
            row["kernel_ms"] = device_ms(torch, lambda: None, call, 10, None)
            row["library_kernel_ms"] = device_ms(torch, lambda: None, lib, 10, None)
    r22p["bound_ms"], r22p["bound_by"] = (
        (TAB_BATCH * (8 + 1 + 4) + TAB_BATCH * int(np.ceil(np.log2(TAB_PK_ROWS))) * 8
         + TAB_BATCH * (4 + 8 + 1)) / MEM_BYTES_PER_S * 1e3, "bytes")
    for b, c in ((1, 33), (33, 33), (4097, 4097), (33, 4097), (4097, 33)):
        kk = torch.from_numpy(rng.integers(0, c // 2 + 1, c).astype(np.int64)).to(dev)  # dups
        vm = torch.from_numpy(rng.random(c) < 0.8).to(dev)
        pr = torch.from_numpy(rng.integers(-1, c // 2 + 2, b).astype(np.int64)).to(dev)
        probe_case(kk, vm, pr, torch.from_numpy(rng.random(b) < 0.9).to(dev))
        fp = pr.to(torch.float32) + torch.from_numpy(
            (rng.random(b) < 0.3) * 0.5).to(dev).to(torch.float32)  # fractional misses
        probe_case(kk, vm, fp, ~torch.isnan(fp))
        fkk = torch.from_numpy(np.resize(fk, c)).to(dev)
        probe_case(fkk, vm, fkk[torch.from_numpy(rng.integers(0, c, b)).to(dev)],
                   torch.ones(b, dtype=torch.bool, device=dev))

    # csrc/radix_sort.cuh: one block up to a tile, the grid above it; keys
    # varying in every byte; an all-empty table. The plain version runs on
    # CPU copies here, as K46's do: on the card the stable torch.sort it
    # calls puts float32 NaNs with the sign bit before -inf, while on the
    # CPU, where the tests hold it against JAX, every NaN ties after +inf
    def build_case(kk, vm):
        want = K.table_index_build_ref(kk.cpu(), vm.cpu())
        exact("table_index_build", K.table_index_build(kk, vm), tuple(x.to(dev) for x in want))

    for c in (1023, 1024, 1025, SORT_TILE - 1, SORT_TILE, SORT_TILE + 1, 2 * SORT_TILE + 1,
              131_073, 1_000_000):
        vm = torch.from_numpy(rng.random(c) < 0.6).to(dev)
        lk = rng.integers(0, c // 2 + 1, c).astype(np.int64)  # duplicates
        stale = rng.random(c) < 0.3
        lk[stale] = rng.integers(0, 1 << 40, int(stale.sum()))
        for arr in (lk, _every_byte_key(rng, "int64", c), _every_byte_key(rng, "float32", c)):
            build_case(torch.from_numpy(arr).to(dev), vm)
    for c in (1000, TAB_ROWS):
        build_case(torch.from_numpy(_every_byte_key(rng, "int64", c)).to(dev),
                   torch.zeros(c, dtype=torch.bool, device=dev))
    # two probe calls in a row on one table: its writer scratch comes back
    # all -1 (each slot's writer resets it)
    for _ in range(2):
        exact("table_index_probe", probe_call(),
              K.table_index_probe_ref(keys, valid, order, sk, pk_probe, ok))
    if not bool((pk_winner == -1).all()):
        raise AssertionError("K22 probe: the writer scratch is not all -1 after two calls")
    # two tables of one capacity probed from two threads at once, each with
    # its own scratch (a ctypes call drops the GIL, so their kernels
    # interleave on the stream)
    pair = []
    for _ in range(2):
        kk = torch.from_numpy(rng.integers(0, 2048, 4097).astype(np.int64)).to(dev)
        vm = torch.from_numpy(rng.random(4097) < 0.8).to(dev)
        pr = torch.from_numpy(rng.integers(0, 2048, TAB_BATCH).astype(np.int64)).to(dev)
        po = torch.ones(TAB_BATCH, dtype=torch.bool, device=dev)
        o_, s_, _d = K.table_index_build_ref(kk, vm)
        pair.append(((kk, vm, o_, s_, pr, po), K.table_index_probe_ref(kk, vm, o_, s_, pr, po),
                     K.winner_scratch(dev, 4097)))
    got = [[], []]

    def prober(i):
        args, _want, w = pair[i]
        for _ in range(50):
            got[i].append(K.table_index_probe(*args, w))

    threads = [threading.Thread(target=prober, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for i in range(2):
        if len(got[i]) != 50:
            raise AssertionError(f"K22 probe: thread {i} did not finish its probes")
        for g in got[i]:
            exact("table_index_probe", g, pair[i][1])
        if not bool((pair[i][2] == -1).all()):
            raise AssertionError("K22 probe: a writer scratch is not all -1 after two threads")
    if index_only:
        for name in ("table_index_build", "table_index_probe"):
            r = res[name]
            print(f"kernel {name}: ms={r['ms']:.4f} device_ms={r['device_ms']:.4f} "
                  f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) "
                  f"library_ms={r['library_ms']:.4f} "
                  f"library_device_ms={r['library_device_ms']:.4f} "
                  f"kernel_ms={r['kernel_ms']:.4f} library_kernel_ms={r['library_kernel_ms']:.4f} "
                  f"checks={r['checks']} exact", flush=True)
        r = res["table_index_build"]
        print(f"kernel table_index_build, empty slots' keys in range: "
              f"device_ms={r['in_range_device_ms']:.4f} "
              f"library_device_ms={r['in_range_library_device_ms']:.4f}", flush=True)
        return {name: res[name] for name in ("table_index_build", "table_index_probe")}

    # ---- K23: the condition match -----------------------------------------
    def program(t, text):
        scope = output_scope(t, out_schema, interner, dev)
        return emit_program(SiddhiCompiler.parse_expression(text), scope, "T")

    def probe_env(cols, ts):
        env = {("__out__", None, n): v for n, v in cols.items()}
        env[("__out__", None, TS_ATTR)] = ts
        return Env(env, now=torch.zeros((), dtype=torch.int64, device=dev))

    def match_case(t, st, text, cols, ts, rows, mode, gate=None):
        prog = program(t, text)
        regs = eval_regs(prog.regs, probe_env(cols, ts), rows.shape[0])
        lanes = K.lane_tensors(prog, st["cols"], st["ts"])
        if gate is not None:
            gate = torch.tensor(gate, device=dev)
        exact("table_match", K.table_match(prog, regs, lanes, st["valid"], rows, mode, gate),
              K.table_match_ref(prog, regs, lanes, st["valid"], rows, mode, gate))
        return prog, regs, lanes

    r23 = res["table_match"]
    t_d = make_table("", "", TAB_ROWS)
    st_d = fill_state(t_d, TAB_ROWS)
    d_cols, d_ts, d_rows = batch_cols(TAB_BATCH, 0, TAB_ROWS, nulls=0.01, dup=0.0)
    dense = "T.k >= k and T.k < k + 8"
    prog, regs, lanes = match_case(t_d, st_d, dense, d_cols, d_ts, d_rows, K.MODE_WRITER)
    match_case(t_d, st_d, dense, d_cols, d_ts, d_rows, K.MODE_DELETE)
    for gate in (False, True):  # the device flag of an auto-index's dense path
        match_case(t_d, st_d, "T.k == k", d_cols, d_ts, d_rows, K.MODE_WRITER, gate)
    r23["ms"] = time_ms(torch, lambda: K.table_match(prog, regs, lanes, st_d["valid"], d_rows,
                                                     K.MODE_WRITER), 3)
    r23["plain_ms"] = time_ms(torch, lambda: K.table_match_ref(prog, regs, lanes, st_d["valid"],
                                                               d_rows, K.MODE_WRITER), 2)
    tk, pk = st_d["cols"]["k"], d_cols["k"]
    r23["library_ms"] = time_ms(torch, lambda: (
        (tk[None, :] >= pk[:, None]) & (tk[None, :] < pk[:, None] + 8)).any(0), 2)
    # the cells this run's data needs: per valid slot, the probe rows from
    # the last down to its writer (all of them where none matches), each the
    # program's arithmetic, compare and logic instructions (not its loads)
    w = K.table_match(prog, regs, lanes, st_d["valid"], d_rows, K.MODE_WRITER).long()
    suffix = torch.flip(torch.cumsum(torch.flip(d_rows.long(), [0]), 0), [0])
    cells = int(torch.where(w >= 0, suffix[w.clamp(min=0)], suffix[0])[st_d["valid"]].sum())
    n_ops = sum(1 for ins in prog.code if ins[0] not in (OP_REG, OP_CONST, K.OP_TAB))
    r23["cells"], r23["ops_per_cell"] = cells, n_ops
    r23["bound_ms"], r23["bound_by"] = max(
        ((TAB_ROWS * (8 + 1 + 4) + TAB_BATCH * (sum(r.element_size() for r in regs) + 1))
         / MEM_BYTES_PER_S * 1e3, "bytes"),
        (cells * n_ops / FP32_OPS_PER_S * 1e3, "operations"))
    t_j = make_table("", "", TAB_JOIN_ROWS)
    st_j = fill_state(t_j, TAB_JOIN_ROWS)
    j_cols, j_ts, j_rows = batch_cols(TAB_BATCH, 0, 2 * TAB_JOIN_ROWS, nulls=0.01, dup=0.0)
    jp, jr, jl = match_case(t_j, st_j, "T.k == k", j_cols, j_ts, j_rows, K.MODE_IN)
    r23["in_ms"] = time_ms(torch, lambda: K.table_match(jp, jr, jl, st_j["valid"], j_rows,
                                                        K.MODE_IN), 5)
    for b, c in ((1, 33), (33, 33), (4097, 4097), (33, 4097), (4097, 33)):
        t = make_table("", "", c)
        st = fill_state(t, c // 2)
        cols, ts, rows = batch_cols(b, -2, c, nulls=0.2, dup=0.2)
        for text in (dense, "T.k == k", "T.v / (k - 3) > 2 or k is null", "v > 5"):
            for mode in (K.MODE_WRITER, K.MODE_DELETE, K.MODE_IN):
                match_case(t, st, text, cols, ts, rows, mode)
        for mode in (K.MODE_WRITER, K.MODE_DELETE, K.MODE_IN):
            match_case(t, st, "T.k == k", cols, ts, rows, mode, False)

    # ---- K24: the sequential update and the update-or-insert --------------
    r24 = res["table_scan"]

    def scan_case(t, st, on, sets, guard, cols, ts, rows, upsert, schema=None):
        scope = output_scope(t, schema or out_schema, interner, dev)
        set_attrs = [UpdateSetAttribute(Variable(n), SiddhiCompiler.parse_expression(x))
                     for n, x in sets] if sets else None
        sp = build_scan_programs(t, scope, SiddhiCompiler.parse_expression(on), set_attrs,
                                 [n for n, _x in sets] if sets else t.schema.attr_names, guard)
        regs = eval_regs(sp.on.regs, probe_env(cols, ts), rows.shape[0])
        if upsert:
            ins = {n: cols[n] for n in t.schema.attr_names}
            got = K.table_upsert_scan(sp, regs, st, rows, ins, ts)
            want = K.table_upsert_scan_ref(sp, regs, st, rows, ins, ts)
        else:
            got = K.table_update_scan(sp, regs, st, rows)
            want = K.table_update_scan_ref(sp, regs, st, rows)
        exact("table_scan", got, want)
        return sp, regs

    t_u = make_table("@PrimaryKey('k')", "@Index('k')", TAB_ROWS)
    st_u = fill_state(t_u, TAB_ROWS // 2, holes=False)
    sp, regs = scan_case(t_u, st_u, "T.k == k", None, None, u_cols, u_ts, u_rows, True)
    ins = {n: u_cols[n] for n in t_u.schema.attr_names}
    r24["ms"] = time_ms(torch, lambda: K.table_upsert_scan(sp, regs, st_u, u_rows, ins, u_ts), 2)
    r24["plain_ms"] = time_once(torch, lambda: K.table_upsert_scan_ref(sp, regs, st_u, u_rows,
                                                                       ins, u_ts))
    r24["library_ms"] = None
    # an equality `on` over a primary key matches at most one slot a row: the
    # function needs an index lookup per row and one pass over the table's
    # lanes (k, v, ts, seq and valid, read and written once) and the rows'
    r24["bound_ms"], r24["bound_by"] = (
        (TAB_ROWS * (8 + 8 + 8 + 8 + 1) * 2 + TAB_BATCH * (8 + 8 + 8 + 1))
        / MEM_BYTES_PER_S * 1e3, "bytes")
    t_s = make_table("", "", TAB_ROWS)
    st_s = fill_state(t_s, TAB_ROWS)
    s_cols, s_ts, s_rows = batch_cols(TAB_BATCH, 0, TAB_ROWS, nulls=0.01, dup=0.3)
    sp2, regs2 = scan_case(t_s, st_s, "T.k == k", [("v", "T.v + v")], None, s_cols, s_ts,
                           s_rows, False)
    r24["update_ms"] = time_ms(torch, lambda: K.table_update_scan(sp2, regs2, st_s, s_rows), 3)
    for b, c, n in ((1, 33, 10), (33, 33, 33), (4097, 4097, 2000), (33, 4097, 4000),
                    (4097, 33, 20)):
        t = make_table("@PrimaryKey('k')", "", c)
        st = fill_state(t, n)
        cols, ts, rows = batch_cols(b, 0, 2 * c, nulls=0.1, dup=0.3)
        scan_case(t, st, "T.k == k", None, None, cols, ts, rows, True)  # full tables overflow
        scan_case(t, st, "T.k == k and T.v > -100", None, None, cols, ts, rows, True)
        scan_case(t, st, "T.k == k", [("v", "T.v + v"), ("k", "T.k")], None, cols, ts, rows,
                  False)
        # the rekey guard: `on T.v == v set T.k = k` (a rekey onto a live key,
        # or of two rows in one event, fails the event)
        cols2 = dict(cols)
        cols2["v"] = torch.from_numpy(rng.integers(0, 2 * c, b).astype(np.int64) * 10).to(dev)
        scan_case(t, st, "T.v == v or T.v == v + 10", [("k", "k"), ("v", "T.v + 1")], "k", cols2,
                  ts, rows, False)
        scan_case(t, st, "T.v == v", [("k", "k")], "k", cols2, ts, rows, False)
    # the update-or-insert by key groups: a non-unique key, repeated
    # new keys in one batch, null keys, tables filling mid-batch, an
    # accumulating set, every column set (the key with the row's own key),
    # and set clauses writing another key (the walk: found on the card, or
    # known on the host)
    n_before = res["table_scan"]["checks"]
    for b, c, n in ((513, 1000, 0), (2049, 4097, 3900), (33, 64, 60), (TAB_BATCH, TAB_ROWS,
                                                                       TAB_ROWS // 2)):
        t = make_table("", "", c)
        st = fill_state(t, n, keys=rng.integers(0, max(n // 2, 1), n))
        cols, ts, rows = batch_cols(b, 0, max(n, 64), nulls=0.1, dup=0.4)
        scan_case(t, st, "T.k == k", [("v", "T.v + v")], None, cols, ts, rows, True)
        if c == TAB_ROWS:  # the plain version walks the rows on the host: ~2 s a call here
            continue
        scan_case(t, st, "T.k == k", None, None, cols, ts, rows, True)
        scan_case(t, st, "T.k == k", [("k", "v"), ("v", "T.v - 1")], None, cols, ts, rows, True)
        scan_case(t, st, "T.k == k", [("k", "k + 1")], None, cols, ts, rows, True)
    # float keys: NaN, both zeros, subnormals and infinities
    pool = np.array([0.0, -0.0, 1.5, 2.5, -3.0, np.nan, 1e-40, -1e-40, np.inf, 7.25],
                    np.float32)
    t = make_table("", "", 4097, cols="k float, v long")
    st = fill_state(t, 2000)
    kf = rng.choice(pool, 4097)
    st["cols"]["k"] = torch.from_numpy(kf).to(dev)
    cols, ts, rows = batch_cols(1024, 0, 100)
    cols["k"] = torch.from_numpy(rng.choice(pool, 1024)).to(dev)
    schema_f = StreamSchema("__out__", [("k", AttrType.FLOAT), ("v", AttrType.LONG)])
    scan_case(t, st, "T.k == k", [("v", "T.v + v")], None, cols, ts, rows, True, schema_f)
    scan_case(t, st, "T.k == k", None, None, cols, ts, rows, True, schema_f)
    print(f"kernel check table_scan: {res['table_scan']['checks'] - n_before} key-group "
          f"upserts (non-unique and float keys, nulls, NaN, tables filling mid-batch, the "
          f"walk): exact", flush=True)
    for name in names:
        r = res[name]
        lib = "None" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"kernel {name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) library_ms={lib} "
              f"checks={r['checks']} exact", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 2, the special windows: K25-K28 against their plain versions
# ---------------------------------------------------------------------------

SW_N, FQ_N, FQ_SYMBOLS, LF_S, LF_E, CR_W = 100, 100, 1000, 0.01, 0.001, 1024
SW_EVENTS = FQ_EVENTS = LF_EVENTS = FN_EVENTS = 1_000_000
CR_CALLS, CR_BUCKET, FN_EVERY = 16, 1000, 4096
SPECIAL_BATCH = 32768
STOCK_HEAD = """@app:batch(size='{batch}')
define stream StockStream (symbol string, price float, volume long);
"""
# the special-window paths (see special_path_phase); `every` is FN's limit
SPECIAL_APPS = {
    # the top-100 book of the highest prices
    "SW": STOCK_HEAD + """@info(name='q') from StockStream#window.sort(100, price, 'desc',
volume, 'asc') select symbol, price, volume, count() as n, sum(volume) as v
insert all events into Out;""",
    # heavy hitters over a skewed key space (Zipf symbols)
    "FQ": STOCK_HEAD + """@info(name='q') from StockStream#window.frequent(100, symbol)
select symbol, count() as c insert all events into Out;""",
    "LF": STOCK_HEAD + """@info(name='q') from StockStream#window.lossyFrequent(0.01, 0.001,
symbol) select symbol, count() as c insert into Out;""",
    "CR": "@app:playback\n" + STOCK_HEAD + """@info(name='q')
from StockStream#window.cron('*/1 * * * * ?')
select symbol, sum(volume) as v, count() as c group by symbol insert all events into Out;""",
    "FN": STOCK_HEAD + """@info(name='q') from StockStream#pol2Cart(price, volume)[x > 0]
select symbol, x, y output last every {every} events insert into Out;""",
}


def zipf_symbols(n: int, seed: int = 7) -> np.ndarray:
    """Symbol ids 1..FQ_SYMBOLS drawn from a Zipf law with exponent 1.2."""
    rng = np.random.default_rng(seed)
    p = np.arange(1, FQ_SYMBOLS + 1, dtype=np.float64) ** -1.2
    return (rng.choice(FQ_SYMBOLS, size=n, p=p / p.sum()) + 1).astype(np.int32)


def special_window_kernel_phase(torch, dev) -> dict:
    """The special windows' steps against their plain versions on the card,
    bit for bit on every output lane (the whole buffer), every state lane and
    the overflow flag, from the same inputs and carried state (made by the
    plain version over earlier batches): the sort (K25) at path SW's shape
    (B=32768, N=100, price desc then volume asc, the book full) and with
    NaN, -0.0 and int-null keys, desc on int keys, ties and the arrival
    evicted (small key sets, N 4/16); the frequent (K26) at path FQ's
    (B=32768, N=100, Zipf keys over 1,000 symbols) and with a full table
    evicting every key at once and dropping new keys (N=4); the
    lossyFrequent (K27) at path LF's (B=32768, 4,000 slots, a prune every
    1,000 rows) and with prunes that evict the arrival, a full key table and
    an overflowing buffer; the cron (K28) at path CR's (a 1,000-row bucket,
    w=1024) with its TIMER row first in the batch, after CURRENT rows and on
    an empty bucket, and a bucket past its w slots; ragged B 1/33/4097; and
    each with slot lanes past shared memory (global scratch: sort N=5000
    with 4 keys, frequent N=20,000, lossyFrequent 40,000 slots, cron
    w=32768)."""
    from siddhi_tpu_torch.core.event import EventBatch, StreamSchema
    from siddhi_tpu_torch.core.types import AttrType
    from siddhi_tpu_torch.core.windows_special import _key_col
    from siddhi_tpu_torch.ops import special_window as K

    names = ("sort_window_step", "frequent_window_step", "lossy_frequent_window_step",
             "cron_window_step")
    res = {k: {"max_abs_err": 0.0, "checks": 0, "library_ms": None} for k in names}
    rng = np.random.default_rng(925)
    schema = StreamSchema("S", [("symbol", AttrType.STRING), ("price", AttrType.FLOAT),
                                ("volume", AttrType.LONG), ("qty", AttrType.INT),
                                ("hot", AttrType.BOOL)])
    prices = np.concatenate([np.array([np.nan, -0.0, 0.0, 1.5, 2.5, 7.0, -3.0], np.float32),
                             SUBNORMALS])
    longs = np.array([LONG_NULL, -5, 0, 3, 9, (1 << 63) - 1], np.int64)
    ints = np.array([-(1 << 31), -1, 0, 2, 4, (1 << 31) - 1], np.int32)

    def batch_of(b, t0, mode="wide", timer_share=0.0, symbols=None, valid_share=0.95):
        """numpy lanes of one batch: 'wide' draws the stock feed's ranges,
        'traps' small sets with NaN, -0.0, nulls and ties."""
        ts = t0 + np.arange(b, dtype=np.int64)
        u = rng.random(b)
        kind = np.where(u < timer_share, 2, np.where(u < timer_share + 0.02, 1, 0)).astype(np.int8)
        if mode == "wide":
            cols = {"symbol": (symbols if symbols is not None
                               else rng.integers(1, 9, b)).astype(np.int32),
                    "price": rng.uniform(0, 100, b).astype(np.float32),
                    "volume": rng.integers(1, 1000, b).astype(np.int64),
                    "qty": rng.integers(0, 50, b).astype(np.int32),
                    "hot": rng.random(b) < 0.5}
        else:
            cols = {"symbol": rng.integers(1, 7, b).astype(np.int32),
                    "price": prices[rng.integers(0, len(prices), b)],
                    "volume": longs[rng.integers(0, len(longs), b)],
                    "qty": ints[rng.integers(0, len(ints), b)],
                    "hot": rng.random(b) < 0.5}
        return EventBatch(ts=torch.from_numpy(ts), kind=torch.from_numpy(kind),
                          valid=torch.from_numpy(rng.random(b) < valid_share),
                          cols={n: torch.from_numpy(c) for n, c in cols.items()})

    def to(tree, d):
        if isinstance(tree, dict):
            return {k: to(v, d) for k, v in tree.items()}
        if isinstance(tree, EventBatch):
            return EventBatch(ts=tree.ts.to(d), kind=tree.kind.to(d), valid=tree.valid.to(d),
                              cols=to(tree.cols, d))
        return tree.to(d)

    def lanes(out):
        return {"ts": out.ts, "kind": out.kind, "valid": out.valid, "cols": out.cols}

    def bytes_of(*trees) -> int:
        return sum(t.numel() * t.element_size() for tr in trees for t in flat(tr))

    def run(name, step, state, batches, now=None, key_of=None, time_it=False):
        """Carry `state` through `batches` with the plain version; the last
        batch also runs on the card from the same state, held bit for bit."""
        for i, b in enumerate(batches):
            t_now = torch.tensor(now if now is not None else int(b.ts[-1]) + 3)
            args = (b, key_of(b)) if key_of is not None else (b,)
            if i + 1 < len(batches):
                state, _out, _f = step(state, *args, t_now)
                continue
            want = step(state, *args, t_now)
            gargs = tuple(to(a, dev) for a in args)
            gstate, gnow = to(state, dev), t_now.to(dev)
            got = step(gstate, *gargs, gnow)
            torch.cuda.synchronize()
            same_bits(torch, [got[0], lanes(got[1]), got[2]],
                      [to(want[0], dev), to(lanes(want[1]), dev), want[2].to(dev)])
            res[name]["checks"] += 1
            if time_it:
                r = res[name]
                r["ms"] = time_ms(torch, lambda: step(gstate, *gargs, gnow), 5)
                r["plain_ms"] = time_once(torch, lambda: step(state, *args, t_now))
                # bytes: every input lane read once, every output lane written once
                r["bound_ms"] = bytes_of(lanes(b), list(args[1:]), state, want[0],
                                         lanes(want[1])) / MEM_BYTES_PER_S * 1e3
                r["bound_by"] = "bytes"
                r["flagged"] = bool(want[2])
            return want

    def key_fn(attrs):
        return lambda b: _key_col(b.cols, schema.attrs, attrs).contiguous()

    from siddhi_tpu_torch.core.windows_special import (CronWindow, FrequentWindow,
                                                       LossyFrequentWindow, SortWindow)

    # K25: sort — path SW's shape, then the traps
    sw_keys = [("price", True), ("volume", False)]
    st = SortWindow(schema, "S", SW_N, sw_keys, "cpu").init_state()
    run("sort_window_step", lambda s, b, t: K.sort_window_step(s, b, t, sw_keys, SW_N), st,
        [batch_of(SPECIAL_BATCH, 0), batch_of(SPECIAL_BATCH, SPECIAL_BATCH)], time_it=True)
    for keys in ([("price", False)], [("price", True)], [("volume", True), ("qty", False)],
                 [("qty", True)], [("hot", True), ("price", False)]):
        for n, b in ((4, 1), (4, 33), (16, 33), (16, 4097)):
            st = SortWindow(schema, "S", n, keys, "cpu").init_state()
            bs = [batch_of(b, i * b, "traps", 0.05) for i in range(12 if b == 1 else 3)]
            bs[0].cols["price"][0] = float("nan")  # a NaN key in slot 0
            run("sort_window_step", lambda s, bb, t, _k=keys, _n=n: K.sort_window_step(
                s, bb, t, _k, _n), st, bs)

    # K26: frequent — path FQ's shape, then a small table evicting and dropping
    fq_key = key_fn(["symbol"])
    st = FrequentWindow(schema, "S", FQ_N, ["symbol"], "cpu").init_state()
    run("frequent_window_step", lambda s, b, k, t: K.frequent_window_step(s, b, k, t, FQ_N), st,
        [batch_of(SPECIAL_BATCH, i * SPECIAL_BATCH, symbols=zipf_symbols(SPECIAL_BATCH, 7 + i))
         for i in range(2)], key_of=fq_key, time_it=True)
    for attrs, n, b in ((["symbol"], 4, 1), (["symbol"], 4, 33), ([], 4, 33), (["price"], 16, 33),
                        (["symbol", "hot"], 4, 4097), (["symbol"], 16, 4097)):
        st = FrequentWindow(schema, "S", n, attrs, "cpu").init_state()
        run("frequent_window_step", lambda s, bb, k, t, _n=n: K.frequent_window_step(
            s, bb, k, t, _n), st, [batch_of(b, i * b, "traps", 0.05)
                                   for i in range(12 if b == 1 else 3)], key_of=key_fn(attrs))

    # K27: lossyFrequent — path LF's shape, prunes evicting the arrival, a full
    # key table and an overflowing buffer
    lf = LossyFrequentWindow(schema, "S", LF_S, LF_E, ["symbol"], "cpu")
    run("lossy_frequent_window_step", lambda s, b, k, t: K.lossy_frequent_window_step(
        s, b, k, t, lf.cap_keys, lf.width, LF_S, LF_E), lf.init_state(),
        [batch_of(SPECIAL_BATCH, i * SPECIAL_BATCH, symbols=zipf_symbols(SPECIAL_BATCH, 9 + i))
         for i in range(2)], key_of=fq_key, time_it=True)
    for s_, e_, attrs, b in ((0.3, 0.1, ["symbol"], 1), (0.3, 0.1, ["symbol"], 33),
                             (0.05, 0.01, [], 4097), (0.5, 0.25, ["price"], 33),
                             (0.26, 0.25, [], 33)):
        w = LossyFrequentWindow(schema, "S", s_, e_, attrs, "cpu")
        st = w.init_state()
        if s_ == 0.26:  # full of distinct keys one row before a boundary
            st["occ"][:] = True
            st["key"][:] = torch.arange(10**6, 10**6 + w.cap_keys)
            st["cnt"][:] = 1
            st["total"] = torch.tensor(3)
        got = run("lossy_frequent_window_step", lambda s, bb, k, t, _w=w: K.lossy_frequent_window_step(
            s, bb, k, t, _w.cap_keys, _w.width, _w.support, _w.error), st,
            [batch_of(b, i * b, "traps", 0.05)
             for i in range(1 if s_ == 0.26 else 12 if b == 1 else 3)], key_of=key_fn(attrs))
        if s_ == 0.26 and not bool(got[2]):
            raise AssertionError("K27: the full key table did not set the overflow flag")

    # K28: cron — path CR's shape (a 1,000-row bucket, its TIMER row first),
    # then TIMER rows anywhere, empty buckets and a bucket past w
    def cron_batch(b, t0, timer_at=(), n_valid=None):
        bb = batch_of(b, t0, valid_share=1.0)
        if n_valid is not None:
            bb.valid[n_valid:] = False
        bb.kind[:] = 0
        for i in timer_at:
            bb.kind[i] = 2
        return bb

    st = CronWindow(schema, "S", "*/1 * * * * ?", "cpu", capacity=CR_W).init_state()
    run("cron_window_step", lambda s, b, t: K.cron_window_step(s, b, t, CR_W), st,
        [cron_batch(SPECIAL_BATCH, i * CR_BUCKET, (0,), CR_BUCKET) for i in range(3)],
        time_it=True)
    for w, b, timers in ((4, 1, (0,)), (4, 33, (0, 7, 8, 20)), (16, 33, (5, 32)),
                         (16, 4097, (0, 100, 2000, 4096)), (1024, 4097, (3000,))):
        st = CronWindow(schema, "S", "*/1 * * * * ?", "cpu", capacity=w).init_state()
        bs = [cron_batch(b, i * b, timers if i % 2 else ()) for i in range(12 if b == 1 else 3)]
        if b == 1:
            bs = [cron_batch(1, i, (0,) if i % 3 == 2 else ()) for i in range(12)]
        run("cron_window_step", lambda s, bb, t, _w=w: K.cron_window_step(s, bb, t, _w), st, bs)
    # slot lanes past shared memory: the steps keep them in global scratch
    keys4 = [("price", False), ("volume", True), ("qty", False), ("hot", True)]
    st = SortWindow(schema, "S", 5000, keys4, "cpu").init_state()
    run("sort_window_step", lambda s, b, t: K.sort_window_step(s, b, t, keys4, 5000), st,
        [batch_of(5000, 0), batch_of(200, 5000)])
    st = FrequentWindow(schema, "S", 20000, [], "cpu").init_state()
    run("frequent_window_step", lambda s, b, k, t: K.frequent_window_step(s, b, k, t, 20000), st,
        [batch_of(4097, i * 4097) for i in range(2)], key_of=key_fn([]))
    lw = LossyFrequentWindow(schema, "S", 0.0002, 0.0001, ["symbol"], "cpu")
    run("lossy_frequent_window_step", lambda s, b, k, t: K.lossy_frequent_window_step(
        s, b, k, t, lw.cap_keys, lw.width, lw.support, lw.error), lw.init_state(),
        [batch_of(4097, i * 4097, symbols=zipf_symbols(4097, i)) for i in range(3)],
        key_of=fq_key)
    st = CronWindow(schema, "S", "*/1 * * * * ?", "cpu", capacity=32768).init_state()
    run("cron_window_step", lambda s, b, t: K.cron_window_step(s, b, t, 32768), st,
        [cron_batch(4097, i * 4097, (0, 4000) if i else ()) for i in range(3)])
    for name in names:
        r = res[name]
        print(f"kernel {name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) library_ms=None "
              f"checks={r['checks']} exact", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 2, the partition slice: K29 and K30 against their plain versions
# ---------------------------------------------------------------------------


def partition_kernel_phase(torch, dev) -> dict:
    """The partitioned length-window step (K29) and the windowed min/max of a
    partition (K30) against their plain versions on the card, bit for bit on
    every output lane (the whole 2B rows), the membership, the rings, the
    totals and the slot lanes, from the same inputs and carried state (made
    by the plain version over earlier batches): at path PT's shape (B=32768,
    P=1024, W=50, 1,000 keys, rings filling in the middle of the second
    batch), B 1/33/4097 x P 1/8/33 with W 1/4/50 (W above a slot's rows),
    keys past capacity (slot P), TIMER and EXPIRED rows, holes, NaN/-0.0
    prices and int nulls, empty slots, and an inner-stream batch whose slots
    arrive out of slot order (a K29 output fed into a second ring), and
    counters past shared memory (9,000 slots; one slot with 8,396
    positions). K30 on each step's membership for float32, int32 and int64,
    min and max."""
    from siddhi_tpu_torch.core.event import EventBatch
    from siddhi_tpu_torch.core.types import AttrType
    from siddhi_tpu_torch.ops import partition as K

    k29, k30 = "partition_length_window_step", "partition_window_extreme"
    res = {k: {"max_abs_err": 0.0, "checks": 0} for k in (k29, k30)}
    rng = np.random.default_rng(1029)
    prices = np.concatenate([np.array([np.nan, -0.0, 0.0, 1.5, 2.5, 7.0, -3.0], np.float32),
                             ARITH_TRAPS])
    cols_of = {"symbol": torch.int32, "price": torch.float32, "qty": torch.int32,
               "volume": torch.int64}
    values = (("price", AttrType.FLOAT), ("qty", AttrType.INT), ("volume", AttrType.LONG))

    def rings(p, w):
        z = lambda dt: torch.zeros((p, w), dtype=dt, device=dev)  # noqa: E731
        return {"cols": {n: z(dt) for n, dt in cols_of.items()}, "ts": z(torch.int64),
                "wts": z(torch.int64), "seq": torch.full((p, w), -1, dtype=torch.int64,
                                                          device=dev),
                "total": torch.zeros(p, dtype=torch.int64, device=dev)}

    def batch_of(b, p, t0, traps=False, slots=None):
        if traps:
            kind = np.where(rng.random(b) < 0.05, 2, np.where(rng.random(b) < 0.03, 1, 0))
            price = prices[rng.integers(0, len(prices), b)]
            qty = np.where(rng.random(b) < 0.05, -(1 << 31), rng.integers(-9, 9, b))
            vol = np.where(rng.random(b) < 0.05, LONG_NULL, rng.integers(-9, 9, b))
            valid = rng.random(b) < 0.9
            slot = np.where(rng.random(b) < 0.05, p, rng.integers(0, p, b))
        else:
            kind = np.zeros(b)
            price = rng.uniform(0, 100, b)
            qty = rng.integers(0, 1000, b)
            vol = rng.integers(1, 1000, b)
            valid = np.ones(b, bool)
            slot = rng.integers(0, p, b)
        if slots is not None:
            slot = slots
        batch = EventBatch(
            ts=torch.from_numpy(t0 + np.arange(b, dtype=np.int64)).to(dev),
            kind=torch.from_numpy(kind.astype(np.int8)).to(dev),
            valid=torch.from_numpy(valid).to(dev),
            cols={"symbol": torch.from_numpy(rng.integers(1, 9, b).astype(np.int32)).to(dev),
                  "price": torch.from_numpy(price.astype(np.float32)).to(dev),
                  "qty": torch.from_numpy(qty.astype(np.int32)).to(dev),
                  "volume": torch.from_numpy(vol.astype(np.int64)).to(dev)})
        return batch, torch.from_numpy(slot.astype(np.int32)).to(dev)

    def lanes(r):
        out, birth, death, st, m = r
        return [out.ts, out.kind, out.valid, out.cols, birth, death, st, m.slot, m.first,
                m.rowlist, m.slot_start, m.elem_slot]

    def check(state, batch, slot, w, p):
        got = K.partition_length_window_step(state, batch, slot, w, p)
        want = K.partition_length_window_step_ref(state, batch, slot, w, p)
        torch.cuda.synchronize()
        same_bits(torch, lanes(got), lanes(want))
        res[k29]["checks"] += 1
        _out, birth, death, _st, m = want
        for col, t in values:
            vals = torch.cat([state["cols"][col].reshape(-1), batch.cols[col]])
            for is_min in (True, False):
                g = K.partition_window_extreme(vals, birth, death, m.slot, m.rowlist,
                                               m.slot_start, w, is_min, t)
                r = K.partition_window_extreme_ref(vals, birth, death, m.slot, m.rowlist,
                                                   m.slot_start, w, is_min, t)
                torch.cuda.synchronize()
                same_bits(torch, g, r)
                res[k30]["checks"] += 1
        return want

    # path PT's shape: 1,000 keys in a 1,024-slot table, three carried batches
    b, p, w = MAIN_BATCH, PT_CAP, PT_W
    state = rings(p, w)
    for i in range(3):
        batch, slot = batch_of(b, p, i * b, slots=rng.integers(0, PT_SYMBOLS, b))
        want = check(state, batch, slot, w, p)
        if i < 2:
            state = want[3]
    pt = dict(state=state, batch=batch, slot=slot, want=want)
    print(f"partition kernels at PT's shape (B={b}, P={p}, W={w}): exact", flush=True)
    # ragged and trap cases
    for bb, pp, ww in itertools.product((1, 33, 4097), (1, 8, 33), (1, 4, 50)):
        if (bb, pp, ww) not in {(1, 1, 1), (1, 8, 50), (1, 33, 4), (33, 1, 4), (33, 8, 50),
                                (33, 33, 1), (4097, 1, 50), (4097, 8, 1), (4097, 33, 4)}:
            continue
        st = rings(pp, ww)
        for i in range(3 if bb > 1 else 8):
            batch, slot = batch_of(bb, pp, i * bb, traps=True)
            st = check(st, batch, slot, ww, pp)[3]
    # empty slots: 33 slots, rows only in 5 of them
    st = rings(33, 4)
    for i in range(3):
        batch, slot = batch_of(513, 33, i * 513, traps=True, slots=rng.integers(0, 5, 513))
        st = check(st, batch, slot, 4, 33)[3]
    # counters past shared memory (global scratch): 9,000 slots, then one
    # slot with 8,396 positions
    st = rings(9000, 2)
    for i in range(2):
        batch, slot = batch_of(600, 9000, i * 600, traps=True)
        st = check(st, batch, slot, 2, 9000)[3]
    batch, slot = batch_of(4200, 1, 0, slots=np.zeros(4200, np.int64))
    check(rings(1, 4), batch, slot, 4, 1)
    # an inner-stream batch: a K29 output (rows in (position, slot) order)
    # inserted as CURRENT rows into a second partitioned ring
    st1, st2 = rings(8, 3), rings(8, 2)
    for i in range(3):
        batch, slot = batch_of(200, 8, i * 200, traps=True)
        out, _b, _d, st1, m = check(st1, batch, slot, 3, 8)
        inner = EventBatch(ts=out.ts, kind=torch.zeros_like(out.kind), valid=out.valid,
                           cols=out.cols)
        st2 = check(st2, inner, m.slot, 2, 8)[3]
    print(f"partition kernels: {res[k29]['checks']} K29 and {res[k30]['checks']} K30 checks "
          "bit for bit", flush=True)

    # times at PT's shape
    state, batch, slot = pt["state"], pt["batch"], pt["slot"]
    _out, birth, death, _st, m = pt["want"]
    r = res[k29]
    r["ms"] = time_ms(torch, lambda: K.partition_length_window_step(state, batch, slot, w, p), 20)
    r["plain_ms"] = time_once(torch, lambda: K.partition_length_window_step_ref(
        state, batch, slot, w, p))
    r["library_ms"] = None
    col_b = sum(torch.tensor([], dtype=dt).element_size() for dt in cols_of.values())
    k29_bytes = (b * (8 + 1 + 1 + 4 + col_b) + p * w * (24 + col_b) + 8 * p  # batch, rings
                 + 2 * b * (8 + 1 + 1 + 4 + 4 + col_b) + (p * w + b) * 16  # rows, membership
                 + p * w * (24 + col_b) + 8 * p + 4 * b + 4 * (p + 1))  # new rings, lists
    r["bound_ms"], r["bound_by"] = k29_bytes / MEM_BYTES_PER_S * 1e3, "bytes"
    r["rows"] = int(m.slot.lt(p).sum())

    r = res[k30]
    vals = torch.cat([state["cols"]["price"].reshape(-1), batch.cols["price"]])
    args = (vals, birth, death, m.slot, m.rowlist, m.slot_start, w, False, AttrType.FLOAT)
    r["ms"] = time_ms(torch, lambda: K.partition_window_extreme(*args), 20)
    r["plain_ms"] = time_once(torch, lambda: K.partition_window_extreme_ref(*args))
    # the library yardstick: a masked amax over the per-slot [rows, W + max c]
    # gather of element values and membership, prebuilt
    counts = (m.slot_start[1:] - m.slot_start[:-1]).long()
    maxc = int(counts.max())
    kk = torch.arange(maxc, device=dev)
    idx = (m.slot_start[:-1, None].long() + kk[None, :]).clamp(max=b - 1)
    batch_e = torch.where(kk[None, :] < counts[:, None], p * w + m.rowlist[idx].long(), -1)
    elems = torch.cat([torch.arange(p * w, device=dev).view(p, w), batch_e], 1)
    e = elems[m.slot.long().clamp(0, p - 1)]
    rows_i = torch.arange(2 * b, device=dev)[:, None]
    member = (m.slot.long() < p)[:, None] & (e >= 0) & (birth[e.clamp(min=0)] <= rows_i) & (
        rows_i < death[e.clamp(min=0)])
    v = vals[e.clamp(min=0)]
    ident = torch.tensor(float("-inf"), device=dev)
    r["library_ms"] = time_ms(torch, lambda: torch.amax(torch.where(member, v, ident), 1), 20)
    live = m.slot < p
    examined = int((w + counts[m.slot.long().clamp(0, p - 1)])[live].sum())
    k30_bytes = vals.numel() * (4 + 4 + 4) + 2 * b * (4 + 4) + b * 4 + 4 * (p + 1)
    r["bound_ms"], r["bound_by"] = max((k30_bytes / MEM_BYTES_PER_S * 1e3, "bytes"),
                                       (examined / FP32_OPS_PER_S * 1e3, "operations"))
    r["examined"] = examined
    for name in (k29, k30):
        r = res[name]
        print(f"kernel {name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) library_ms={r['library_ms']} "
              f"checks={r['checks']} exact", flush=True)
    return res


PTW_KERNELS = ("partition_time_window_step", "partition_batch_window_step",
               "partition_assign_slots")


def partition_windows_kernel_phase(torch, dev) -> dict:
    """The partitioned time window (K31), batch window (K32) and per-
    partition group-slot assignment (K33) against their plain versions on
    the card, bit for bit on every output lane, the membership, the state,
    next_timer and the slot lanes, from the same inputs and carried state
    (made by the plain version over earlier batches). K31 at path PTE's
    shape (B=32768, P=1024, W=1024, externalTime 60 s over 1 ms ticks, 1,000
    keys) on two data steps and a TIMER step over every slot, then ragged
    B/P/W with TIMER rows among the data, a disordered externalTime, rings
    that evict at capacity and timeLength. K32 at path PTB's shape (a
    1-second timeBatch, P=32 with 3 keys, one 1,000-event bucket a call, the
    closing TIMER step) and at a value-partitioned lengthBatch(64) (P=1024,
    B=32768), with and without the EXPIRED lanes, then an externalTimeBatch
    idle timeout at rank 0 and after a CURRENT row of the same and of
    another slot, and ragged shapes with TIMER rows and start times. K33
    with one partition overflowing its G and per-partition RESET rows."""
    from siddhi_tpu_torch.core.event import EventBatch
    from siddhi_tpu_torch.core.windows import NO_TIMER
    from siddhi_tpu_torch.ops import group as G
    from siddhi_tpu_torch.ops import partition as K

    k31, k32, k33 = PTW_KERNELS
    res = {k: {"max_abs_err": 0.0, "checks": 0} for k in PTW_KERNELS}
    rng = np.random.default_rng(1031)
    cols_of = {"symbol": torch.int32, "price": torch.float32, "volume": torch.int64}
    col_b = 4 + 4 + 8

    def batch_of(b, ts, kind, slot, valid=None):
        return EventBatch(
            ts=torch.from_numpy(np.asarray(ts, np.int64)).to(dev),
            kind=torch.from_numpy(np.asarray(kind, np.int8)).to(dev),
            valid=torch.from_numpy(np.ones(b, bool) if valid is None else valid).to(dev),
            cols={"symbol": torch.from_numpy(rng.integers(1, 9, b).astype(np.int32)).to(dev),
                  "price": torch.from_numpy(rng.uniform(0, 100, b).astype(np.float32)).to(dev),
                  "volume": torch.from_numpy(rng.integers(1, 1000, b)).to(dev)}), \
            torch.from_numpy(np.asarray(slot, np.int32)).to(dev)

    # ---- K31 ----------------------------------------------------------
    def rings(p, w):
        z = lambda dt: torch.zeros((p, w), dtype=dt, device=dev)  # noqa: E731
        return {"cols": {n: z(dt) for n, dt in cols_of.items()}, "ts": z(torch.int64),
                "wts": z(torch.int64), "seq": torch.full((p, w), -1, dtype=torch.int64,
                                                          device=dev),
                "total": torch.zeros(p, dtype=torch.int64, device=dev)}

    def tw_lanes(r):
        out, birth, death, st, nt, m = r
        return [out.ts, out.kind, out.valid, out.cols, birth, death, st, nt, m.slot, m.first,
                m.rowlist, m.slot_start, m.elem_slot]

    def check31(state, batch, bwts, slot, w, t, p):
        got = K.partition_time_window_step(state, batch, bwts, slot, w, t, p)
        want = K.partition_time_window_step_ref(state, batch, bwts, slot, w, t, p)
        torch.cuda.synchronize()
        same_bits(torch, tw_lanes(got), tw_lanes(want))
        res[k31]["checks"] += 1
        return want

    b, p, w, t = MAIN_BATCH, PT_CAP, 1024, 60_000
    state = rings(p, w)
    for i in range(2):
        ts = i * b + np.arange(b)
        batch, slot = batch_of(b, ts, np.zeros(b), rng.integers(0, PT_SYMBOLS, b))
        want = check31(state, batch, batch.ts, slot, w, t, p)
        state = want[3]
    pte = dict(state=state, batch=batch, slot=slot)
    tb, tslot = batch_of(1, [2 * b + t], [2], [p])
    check31(state, tb, tb.ts, tslot, w, t, p)
    print(f"K31 at PTE's shape (B={b}, P={p}, W={w}) and a TIMER step: exact", flush=True)
    for bb, pp, ww, tt in ((1, 1, 1, 5), (33, 1, 4, 3), (33, 8, 4, 7), (513, 33, 16, 20),
                           (513, 5, 1024, 50), (4097, 33, 8, 100)):
        st = rings(pp, ww)
        for i in range(3):
            kind = np.where(rng.random(bb) < 0.1, 2, np.where(rng.random(bb) < 0.03, 1, 0))
            ts = i * bb + np.arange(bb)
            disorder = ts + rng.integers(-tt, tt + 1, bb)  # a disordered externalTime
            slot = np.where(rng.random(bb) < 0.05, pp, rng.integers(0, pp, bb))
            batch, sl = batch_of(bb, ts, kind, slot, valid=rng.random(bb) < 0.95)
            for bw in (batch.ts, torch.from_numpy(disorder.astype(np.int64)).to(dev)):
                want = check31(st, batch, bw, sl, ww, tt, pp)
            st = want[3]
    # ---- K32 ----------------------------------------------------------
    def buffers(p, w):
        z = lambda dt: torch.zeros((p, w), dtype=dt, device=dev)  # noqa: E731
        return {"cur_cols": {n: z(dt) for n, dt in cols_of.items()}, "cur_ts": z(torch.int64),
                "cur_n": torch.zeros(p, dtype=torch.int32, device=dev),
                "prev_cols": {n: z(dt) for n, dt in cols_of.items()}, "prev_ts": z(torch.int64),
                "prev_n": torch.zeros(p, dtype=torch.int32, device=dev),
                "bucket_start": torch.full((p,), -1, dtype=torch.int64, device=dev),
                "timeout_deadline": torch.full((p,), NO_TIMER, dtype=torch.int64, device=dev)}

    def bw_lanes(r):
        out, birth, death, st, nt, m = r
        return [out.ts, out.kind, out.valid, out.cols, birth, death, st, nt, m.slot, m.first,
                m.rowlist, m.slot_start, m.elem_slot]

    def check32(state, batch, wts, now, slot, p, w, n, t, start, timeout, mode, emit):
        args = (state, batch, wts, torch.tensor(now, device=dev), slot, p, w, n, t, start,
                timeout, mode, emit)
        got = K.partition_batch_window_step(*args)
        want = K.partition_batch_window_step_ref(*args)
        torch.cuda.synchronize()
        lanes_g, lanes_w = bw_lanes(got), bw_lanes(want)
        if not emit:
            lanes_g, lanes_w = lanes_g[:4] + lanes_g[6:], lanes_w[:4] + lanes_w[6:]
        same_bits(torch, lanes_g, lanes_w)
        res[k32]["checks"] += 1
        return want

    # PTB: a 1-second timeBatch over three price bands, one bucket a call,
    # then the TIMER row that closes it
    pb_p, pb_w, pb_b = 32, 1024, 1000
    st = buffers(pb_p, pb_w)
    for i in range(2):
        ts = 1000 * i + np.sort(rng.integers(0, 1000, pb_b))
        batch, slot = batch_of(pb_b, ts, np.zeros(pb_b), rng.integers(0, 3, pb_b))
        st = check32(st, batch, batch.ts, 1000 * i, slot, pb_p, pb_w, None, 1000, None, None,
                     1, False)[3]
        tb, tslot = batch_of(1, [1000 * (i + 1)], [2], [pb_p])
        st = check32(st, tb, tb.ts, 1000 * (i + 1), tslot, pb_p, pb_w, None, 1000, None, None,
                     1, False)[3]
    ptb = dict(state=st, batch=batch, slot=slot)
    # a value-partitioned lengthBatch(64), P=1024, with and without EXPIRED lanes
    for emit in (False, True):
        st = buffers(PT_CAP, 64)
        for i in range(2):
            batch, slot = batch_of(b, i * b + np.arange(b), np.zeros(b),
                                   rng.integers(0, PT_SYMBOLS, b))
            want = check32(st, batch, batch.ts, 0, slot, PT_CAP, 64, 64, None, None, None, 0,
                           emit)
            st = want[3]
        if not emit:
            lb = dict(state=st, batch=batch, slot=slot)
    print(f"K32 at PTB's shape (P={pb_p}, w={pb_w}, {pb_b} rows a bucket) and lengthBatch(64) "
          f"(B={b}, P={PT_CAP}): exact", flush=True)
    # externalTimeBatch with an idle timeout: a TIMER at rank 0, after a
    # CURRENT row of the same slot and of another slot
    st = buffers(4, 8)
    batch, slot = batch_of(6, [0, 1, 2, 3, 4, 5], [0] * 6, [0, 1, 0, 1, 2, 0])
    st = check32(st, batch, batch.ts, 10, slot, 4, 8, None, 100, None, 50, 2, True)[3]
    for kinds, slots, now in (([2, 0, 2], [4, 0, 4], 100), ([0, 2, 2], [1, 4, 4], 200),
                              ([2, 2], [4, 4], 400)):
        batch, slot = batch_of(len(kinds), [now] * len(kinds), kinds, slots)
        st = check32(st, batch, batch.ts, now, slot, 4, 8, None, 100, None, 50, 2, True)[3]
    for bb, pp, ww, n, tt, start, mode in ((33, 8, 4, 4, None, None, 0),
                                           (513, 33, 16, 16, None, None, 0),
                                           (33, 5, 8, None, 10, None, 1),
                                           (513, 33, 64, None, 25, 7, 1),
                                           (200, 3, 4, None, 30, None, 0)):
        for emit in (False, True):
            st = buffers(pp, ww)
            for i in range(3):
                kind = np.where(rng.random(bb) < 0.1, 2, np.where(rng.random(bb) < 0.03, 1, 0))
                ts = i * bb + np.arange(bb)
                slot = np.where(rng.random(bb) < 0.05, pp, rng.integers(0, pp, bb))
                batch, sl = batch_of(bb, ts, kind, slot, valid=rng.random(bb) < 0.95)
                st = check32(st, batch, batch.ts, int(ts[-1]), sl, pp, ww, n, tt, start, None,
                             mode, emit)[3]
    print(f"K32: {res[k32]['checks']} checks bit for bit", flush=True)

    # ---- K33 ----------------------------------------------------------
    def check33(tab, keys, active, reset, pslot, p):
        got = G.partition_assign_slots(tab["keys"], tab["used"], tab["n"], keys, active, reset,
                                       pslot, p)
        want = G.partition_assign_slots_ref(tab["keys"], tab["used"], tab["n"], keys, active,
                                            reset, pslot, p)
        torch.cuda.synchronize()
        same_bits(torch, list(got), list(want))
        res[k33]["checks"] += 1
        return {"keys": want[0], "used": want[1], "n": want[2]}

    def table(p, g):
        return {"keys": torch.zeros((p, g), dtype=torch.int64, device=dev),
                "used": torch.zeros((p, g), dtype=torch.bool, device=dev),
                "n": torch.zeros(p, dtype=torch.int32, device=dev)}

    def assign_inputs(rows, p, n_keys, reset_p):
        keys = torch.from_numpy(rng.integers(0, n_keys, rows)).to(dev)
        kind = rng.random(rows)
        reset = torch.from_numpy(kind < reset_p).to(dev)
        active = torch.from_numpy((kind >= reset_p) & (kind < 0.95)).to(dev)
        pslot = torch.from_numpy(np.where(rng.random(rows) < 0.03, p, rng.integers(0, p, rows))
                                 .astype(np.int32)).to(dev)
        return keys, active, reset, pslot

    # PTB's group table: 3 bands of 1,024 groups, 1,000 symbols, the
    # RESET rows of a flush in each band
    tab = table(pb_p, 1024)
    for i in range(3):
        keys, active, reset, pslot = assign_inputs(1100, 3, PT_SYMBOLS, 0.003)
        tab = check33(tab, keys, active, reset, pslot, pb_p)
    ptb_assign = dict(tab=tab, args=(keys, active, reset, pslot))
    for rows, p_, g, n_keys, rp in ((1, 1, 1, 3, 0.0), (33, 4, 3, 10, 0.1), (513, 33, 8, 12, 0.02),
                                    (4097, 8, 64, 100, 0.01), (600, 9000, 2, 3, 0.05)):
        tab = table(p_, g)
        for i in range(3):
            tab = check33(tab, *assign_inputs(rows, p_, n_keys, rp), p_)
    # one partition overflowing: 40 keys into partition 0's G=16, partition 1 fits
    tab = table(2, 16)
    keys = torch.from_numpy(np.concatenate([np.arange(40), np.arange(8)])).to(dev)
    pslot = torch.from_numpy(np.array([0] * 40 + [1] * 8, np.int32)).to(dev)
    ones = torch.ones(48, dtype=torch.bool, device=dev)
    check33(tab, keys, ones, ~ones, pslot, 2)
    print(f"K33: {res[k33]['checks']} checks bit for bit", flush=True)

    # ---- times ----------------------------------------------------------
    state, batch, slot = pte["state"], pte["batch"], pte["slot"]
    r = res[k31]
    f31 = lambda: K.partition_time_window_step(state, batch, batch.ts, slot, w, t, p)  # noqa: E731
    r["ms"] = time_ms(torch, f31, 10)
    r["plain_ms"] = time_once(torch, lambda: K.partition_time_window_step_ref(
        state, batch, batch.ts, slot, w, t, p))
    out = f31()[0]
    rows = out.capacity
    lane_b = 8 + 1 + 1 + 4 + 4 + 4 + col_b
    r["bound_ms"] = (b * (8 + 1 + 1 + 4 + 8 + col_b) + 2 * p * w * (24 + col_b) + 16 * p
                     + rows * lane_b + (p * w + b) * 16) / MEM_BYTES_PER_S * 1e3
    r["bound_by"], r["library_ms"], r["rows"] = "bytes", None, rows
    r = res[k32]
    st, batch, slot = ptb["state"], ptb["batch"], ptb["slot"]
    now = torch.tensor(3000, device=dev)
    f32 = lambda: K.partition_batch_window_step(  # noqa: E731
        st, batch, batch.ts, now, slot, pb_p, pb_w, None, 1000, None, None, 1, False)
    r["ms"] = time_ms(torch, f32, 20)
    r["plain_ms"] = time_once(torch, lambda: K.partition_batch_window_step_ref(
        st, batch, batch.ts, now, slot, pb_p, pb_w, None, 1000, None, None, 1, False))
    rows = f32()[0].capacity
    r["bound_ms"] = (pb_b * (8 + 1 + 1 + 4 + 8 + col_b) + 4 * pb_p * pb_w * (8 + col_b)
                     + 40 * pb_p + rows * lane_b) / MEM_BYTES_PER_S * 1e3
    r["bound_by"], r["library_ms"], r["rows"] = "bytes", None, rows
    st, batch, slot = lb["state"], lb["batch"], lb["slot"]
    r["lengthbatch64_ms"] = time_ms(torch, lambda: K.partition_batch_window_step(
        st, batch, batch.ts, now, slot, PT_CAP, 64, 64, None, None, None, 0, False), 10)
    r = res[k33]
    tab, args = ptb_assign["tab"], ptb_assign["args"]
    f33 = lambda: G.partition_assign_slots(tab["keys"], tab["used"], tab["n"], *args, pb_p)  # noqa: E731
    r["ms"] = time_ms(torch, f33, 20)
    r["plain_ms"] = time_once(torch, lambda: G.partition_assign_slots_ref(
        tab["keys"], tab["used"], tab["n"], *args, pb_p))
    nrows = args[0].shape[0]
    r["bound_ms"] = (nrows * (8 + 1 + 1 + 4 + 4 + 4) + 2 * pb_p * 1024 * 9 + 8 * pb_p) \
        / MEM_BYTES_PER_S * 1e3
    r["bound_by"] = "bytes"
    # the library yardstick: one torch.unique of the (partition, key) pairs
    pair = args[3].to(torch.int64) * (1 << 40) + args[0]
    r["library_ms"] = time_ms(torch, lambda: torch.unique(pair, return_inverse=True), 20)
    for name in PTW_KERNELS:
        r = res[name]
        lib = "None" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"kernel {name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) library_ms={lib} "
              f"checks={r['checks']} exact", flush=True)
    return res


PP_KERNELS = ("partition_pattern_advance", "partition_pattern_count", "partition_pattern_emit",
              "partition_pattern_scan", "pattern_chunks", "pattern_place", "partition_rows")
PP_T = 128  # @app:patternCapacity's default: T a partition
# each wrapper's CUDA kernels, by the names torch.profiler gives them
# the row lists' kernels (csrc/partition_rows.cuh), by torch.profiler's names
ROWS_KERNEL_NAMES = ("rows_tile_kernel(", "rows_grid_kernel(")
PP_DEVICE_NAMES = {
    "partition_pattern_advance": ("advance_kernel(", "fork_kernel("),
    "partition_pattern_count": ("count_kernel(",),
    "partition_pattern_emit": ("emit_kernel(",),
    "partition_pattern_scan": ("scan_kernel<",),
    "pattern_chunks": ("chunks_kernel(",),
    "pattern_place": ("place_stretch_kernel(", "place_rows_kernel(", "gather_kernel("),
    "partition_rows": ROWS_KERNEL_NAMES,
}


def device_ms(torch, setup, fn, reps: int, names) -> float:
    """Mean device time per fn() call of the CUDA kernels whose names hold
    one of `names` (None: every kernel), from torch.profiler over `reps`
    calls, each after setup() (whose kernels are not counted unless names
    is None): the kernels alone, without the wrapper's host work or the
    gaps between them. Raises when the profiler records none of them in
    three tries.
    torch.profiler can lose device events late in a long run of this
    script; `device_all_ms` does not use it."""
    from torch.profiler import ProfilerActivity, profile

    setup()
    fn()
    torch.cuda.synchronize()
    for _attempt in range(3):  # now and then the profiler records no device event
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                setup()
                fn()
            torch.cuda.synchronize()
        us = 0.0
        for e in prof.key_averages():
            if names is None or any(n in e.key for n in names):
                dev_us = getattr(e, "self_device_time_total", None)
                us += e.self_cuda_time_total if dev_us is None else dev_us
        if us > 0:
            return us / 1e3 / reps
    raise AssertionError(f"torch.profiler recorded no device time for {names}")


def device_all_ms(torch, fn, reps: int) -> float:
    """Mean device time per fn() call of everything it runs on the card: the
    calls are queued behind a sleep kernel that outlasts their queueing, so
    the card runs them back to back and CUDA events around them see no host
    time (a wrapper's kernels without its host work, or a library call's
    whole device work). torch.profiler loses device events late in a long
    run of this script, so it is not used here."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0  # one call's host time, queueing included
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(max(2e-3, 3 * reps * host_s) * 2e9))  # cycles at <= 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def changed_bytes(torch, before, after) -> int:
    """Bytes of the elements of a tree of tensors that differ bit for bit
    (the least a function updating them in place must write)."""
    total = 0
    for b, a in zip(flat(before), flat(after), strict=True):
        n = a.numel()
        if not n:
            continue
        bb, ab = (x.contiguous().reshape(-1).view(torch.uint8).reshape(n, -1) for x in (b, a))
        total += int((bb != ab).any(1).sum()) * bb.shape[1]
    return total


def time_inplace(torch, setup, fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls, each after setup() (not
    timed) restores the state fn updates in place; CUDA events."""
    setup()
    fn()
    total = 0.0
    for _ in range(reps):
        setup()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def partition_pattern_kernel_phase(torch, dev) -> dict:
    """The keyed pattern kernels against their plain versions on the card,
    bit for bit on every lane of the [P*T] token table, the entry rows, the
    emission stretches and their counts, the overflow flag and the placed
    rows: the chunk lists and each chunk's K34 passes and K36 completions
    at path PPF's shape (P=1024, T=128, B=32768, C=64, 1,000 keys) on
    three chunks, K35 at PPC's (C=256) on three chunks, K37 at PPA's
    (P=1024, T=128, 1,000 keys) on a 4,096-row data step and on a TIMER
    step over 1,024 slots with deadlines due in 8; then every chunk of
    ragged B/P/T (P 5 and 33: not multiples of 32) with TIMER
    and unmatched rows, chunks cut across one slot's run of rows, slots
    left at their initial table (first used mid-batch), the `every` fork
    overflowing in one slot only, an emission stretch overflowing in one
    slot only, sequences, a count tail slot, a cross-ref [P*T, C]
    condition and two streams on one key table; the placement
    (`pattern_place`) after each run."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core import pattern as PM
    from siddhi_tpu_torch.core.event import EventBatch
    from siddhi_tpu_torch.core.pattern_runtime import PatternPartition
    from siddhi_tpu_torch.ops import partition as K

    k34, k35, k36, k37, kch, kpl, kr = PP_KERNELS
    res = {k: {"max_abs_err": 0.0, "checks": 0} for k in PP_KERNELS}
    rng = np.random.default_rng(1212)
    t0 = 1_700_000_000_000
    kernel_fn = {k34: PM.partition_pattern_advance, k35: PM.partition_pattern_count,
                 k36: PM.partition_pattern_emit}
    plain_fn = {k34: PM.partition_pattern_advance_ref, k35: PM.partition_pattern_count_ref,
                k36: PM.partition_pattern_emit_ref}

    def query(pattern, T, P, B, select="e1.symbol as s"):
        ql = (f"@app:batch(size='{B}') @app:partitionCapacity(size='{P}') "
              f"@app:patternCapacity(size='{T}')\n"
              "define stream S (symbol string, price float, volume long);\n"
              "define stream S2 (symbol string, price float, volume long);\n"
              "partition with (symbol of S, symbol of S2) begin @info(name='q') "
              f"from {pattern} select {select} insert into Out; end;")
        return SiddhiManager(device=dev).create_siddhi_app_runtime(ql).queries["q"]

    def clone(tok):
        return PM._tok_map(tok, torch.clone)

    def table(qr, P, active=0.5, done=False, virgin=0.1, count=False):
        """A random [P*T] token table; `virgin` of the slots left at the
        initial table (a key first seen in this batch)."""
        prog = qr.prog
        T, S, N = prog.T, len(prog.slots), P * prog.T
        tok = PM.keyed_tok(qr.init_state(t0)["tok"])
        lane0 = np.arange(N) % T == 0
        keep = torch.from_numpy(np.repeat(rng.random(P) < virgin, T)).to(dev)
        act = (rng.random(N) < active) | lane0
        sl = rng.integers(0, S + 1 if done else S, N).astype(np.int32)
        sl[lane0] = 0
        start = np.where(rng.random(N) < 0.3, -1, t0 - rng.integers(0, 2000, N))
        start[lane0] = -1
        new = {"active": act, "slot": sl, "start_ts": start.astype(np.int64),
               "entry_ts": (t0 - rng.integers(0, 500, N)).astype(np.int64)}

        def mix(old, arr):
            x = torch.from_numpy(arr).to(device=dev, dtype=old.dtype)
            k = keep.reshape((N,) + (1,) * (old.dim() - 1))
            return torch.where(k, old, x)

        for k, v in new.items():
            tok[k] = mix(tok[k], v)
        for a, c in zip(prog.refs, tok["caps"]):
            n = rng.integers(0, a.cap + 3 if count else 2, N).astype(np.int32)
            n[lane0] = 0
            c["n"] = mix(c["n"], n)
            c["ts"] = mix(c["ts"], t0 - rng.integers(0, 500, tuple(c["ts"].shape)))
            for name, arr in c["cols"].items():
                vals = (rng.uniform(0, 100, tuple(arr.shape)) if arr.dtype.is_floating_point
                        else rng.integers(1, 9, tuple(arr.shape)))
                c["cols"][name] = mix(arr, vals)
        return tok

    def batch(B, P, keys=None, timer=0.0, dense=False, one_slot=None, t_start=t0):
        ts = t_start + np.cumsum(rng.integers(0, 3, B))
        kind = np.where(rng.random(B) < timer, 2, 0).astype(np.int8)
        slot = rng.integers(0, keys or P, B)
        if one_slot is not None:
            slot[:] = one_slot
        slot[rng.random(B) < 0.03] = P  # rows of no partition
        price = (np.where(rng.random(B) < 0.5, 99.5, 0.5) if dense
                 else rng.uniform(0, 100, B)).astype(np.float32)
        bt = EventBatch(
            ts=torch.from_numpy(ts.astype(np.int64)).to(dev),
            kind=torch.from_numpy(kind).to(dev),
            valid=torch.from_numpy(rng.random(B) < 0.97).to(dev),
            cols={"symbol": torch.from_numpy(rng.integers(1, 9, B).astype(np.int32)).to(dev),
                  "price": torch.from_numpy(price).to(dev),
                  "volume": torch.from_numpy(rng.integers(1, 1000, B)).to(dev)})
        return bt, torch.from_numpy(slot.astype(np.int32)).to(dev)

    class St:
        def __init__(self, tok, er, emis, ovf):
            self.tok, self.er, self.emis, self.ovf = tok, er, emis, ovf

        def lanes(self):
            return [self.tok, self.er, self.emis.out, self.emis.n, self.ovf]

    def chunk_states(qr, P, tok, caps):
        prog = qr.prog
        out = []
        for _ in range(2):
            out.append(St(clone(tok), torch.full((P * prog.T,), -1, dtype=torch.int32,
                                                 device=dev),
                          PM.keyed_out(prog, caps, qr.out_cap),
                          torch.zeros((), dtype=torch.bool, device=dev)))
        return out

    def check_chunks(ch, P):
        want = K.pattern_chunks_ref(ch.ts, ch.v, ch.slot, ch.C, P)
        torch.cuda.synchronize()
        same_bits(torch, [ch.rows, ch.srow, ch.nseg], [want.rows, want.srow, want.nseg])
        live = torch.arange(ch.k * ch.C, device=dev) % ch.C < ch.nseg.repeat_interleave(ch.C)
        same_bits(torch, [x[live] for x in (ch.seg_slot, ch.seg_lo, ch.seg_hi)],
                  [x[live] for x in (want.seg_slot, want.seg_lo, want.seg_hi)])
        res[kch]["checks"] += 1

    def check_place(emis, P):
        got = K.pattern_place(emis.out, emis.off, emis.cap, emis.n, P)
        want = K.pattern_place_ref(emis.out, emis.off, emis.cap, emis.n, P)
        torch.cuda.synchronize()
        same_bits(torch, list(got), list(want))
        res[kpl]["checks"] += 1
        return got

    def chunk_route(label, qr, P, tok, bt, slot, sid="S", chunks=None, emis_caps=None,
                    want_overflow=None):
        """Each chunk through the path's own dispatch (`keyed_chunk`: K35,
        K34 for each NFA slot, K36), each kernel against its plain version
        from the same state (the plain version's state carries on)."""
        prog = qr.prog
        now = torch.tensor(int(bt.ts.max()), device=dev)
        pctx = PatternPartition(slot=slot, used=None, fresh=None, p=P, overflow=None)
        ch, caps, inputs = qr.keyed_chunk_inputs(bt, now, sid, pctx)
        check_chunks(ch, P)
        if emis_caps is not None:
            caps = emis_caps(caps)
        sk, sr = chunk_states(qr, P, tok, caps)

        def checked(name):
            def call(*args, **kw):
                if chunks is not None:  # a chunk taken alone starts from the plain state
                    sk.tok, sk.er, sk.ovf = clone(sr.tok), sr.er.clone(), sr.ovf.clone()
                    sk.emis.n.copy_(sr.emis.n)
                    for k_, v_ in sr.emis.out.items():
                        sk.emis.out[k_].copy_(v_)
                swap = {id(sr.tok): sk.tok, id(sr.er): sk.er, id(sr.emis): sk.emis,
                        id(sr.ovf): sk.ovf}
                kernel_fn[name](*[swap.get(id(a), a) for a in args], **kw)
                plain_fn[name](*args, **kw)
                torch.cuda.synchronize()
                same_bits(torch, sk.lanes(), sr.lanes())
                res[name]["checks"] += 1

            return call

        impl = {"advance": checked(k34), "count": checked(k35), "emit": checked(k36)}
        for i in (range(ch.k) if chunks is None else chunks):
            qr.keyed_chunk(i, sr.tok, sr.er, ch, inputs, sr.emis, now, sr.ovf, impl=impl)
        if want_overflow is not None and bool(sr.ovf) != want_overflow:
            raise AssertionError(f"{label}: overflow {bool(sr.ovf)}, expected {want_overflow}")
        rows = check_place(sr.emis, P)[0]["valid"].sum().item()
        print(f"kernel check {label}: P={P} T={prog.T} B={bt.capacity} C={ch.C}, "
              f"{ch.k if chunks is None else len(chunks)} chunks, {int(ch.nseg.sum())} "
              f"segments, {rows} rows placed, overflow {bool(sr.ovf)}: exact", flush=True)
        return dict(qr=qr, P=P, tok=tok, ch=ch, inputs=inputs, caps=caps, now=now)

    def scan(label, qr, P, tok, bt, slot, used, sid="S", seen=None, caps=None):
        prog = qr.prog
        ev, rmask, regs = prog.scan_inputs(sid, bt)
        rows = K.partition_rows(bt, slot, P)
        want_rows = K.partition_rows_ref(bt, slot, P)
        nt = int(want_rows.info[3])
        torch.cuda.synchronize()
        same_bits(torch, [rows.rowlist, rows.slot_start, rows.timers[:nt], rows.info[3]],
                  [want_rows.rowlist, want_rows.slot_start, want_rows.timers, want_rows.info[3]])
        res[kr]["checks"] += 1
        if seen is None:
            seen = torch.full((P,), -(1 << 62), dtype=torch.int64, device=dev)
        if caps is None:
            caps = torch.where(used, torch.clamp(2 * rows.rows.to(torch.int64) + 8,
                                                 max=qr.out_cap), 0)
        out = []
        for fn, rw in ((PM.partition_pattern_scan, rows),
                       (PM.partition_pattern_scan_ref, want_rows)):
            emis = PM.keyed_out(prog, caps, qr.out_cap)
            ovf = torch.zeros((), dtype=torch.bool, device=dev)
            new = fn(prog, tok, sid, bt.ts, bt.kind, bt.valid, ev, rmask, regs, rw, used, emis,
                     ovf, seen)
            out.append([new, emis.out, emis.n, ovf])
        torch.cuda.synchronize()
        same_bits(torch, out[0], out[1])
        res[k37]["checks"] += 1
        emis_n = out[1][2]
        print(f"kernel check {label}: P={P} T={prog.T} B={bt.capacity}, "
              f"{int(used.sum())} used slots, {int(emis_n.sum())} emissions, "
              f"overflow {bool(out[1][3])}: exact", flush=True)
        return dict(prog=prog, tok=tok, sid=sid, bt=bt, ev=ev, rmask=rmask, regs=regs,
                    rows=rows, used=used, caps=caps, seen=seen, out_cap=qr.out_cap,
                    want=out[1])

    # ---- at the paths' shapes ------------------------------------------
    P, B = PT_CAP, MAIN_BATCH
    ppf = query(PP_PATTERNS["PPF"][0].replace("StockStream", "S"), PP_T, P, B,
                PP_PATTERNS["PPF"][1])
    bt, slot = batch(B, P, keys=PT_SYMBOLS)
    ppf_run = chunk_route("K34/K36 at PPF's shape", ppf, P, table(ppf, P, 0.3), bt, slot,
                          chunks=[0, 255, 511])
    ppc = query(PP_PATTERNS["PPC"][0].replace("StockStream", "S"), PP_T, P, B,
                PP_PATTERNS["PPC"][1])
    ppc_run = chunk_route("K35/K36 at PPC's shape", ppc, P, table(ppc, P, 0.3, count=True), bt,
                          slot, chunks=[0, 63, 127])
    ppa = query(PP_PATTERNS["PPA"][0].replace("StockStream", "S"), PP_T, P, B,
                PP_PATTERNS["PPA"][1])
    used = torch.from_numpy(rng.random(P) < 0.98).to(dev)
    bt_a, slot_a = batch(4096, P, keys=PT_SYMBOLS)
    ppa_run = scan("K37 at PPA's shape (4,096 rows)", ppa, P, table(ppa, P, 0.3), bt_a, slot_a,
                   used)
    # a TIMER step over 1,024 slots, deadlines due in 8 of them
    tok = PM.keyed_tok(ppa.init_state(t0)["tok"])
    due = rng.choice(P, 8, replace=False)
    for q in due:
        lanes = slice(q * PP_T + 1, q * PP_T + 4)
        tok["active"][lanes] = True
        tok["slot"][lanes] = 1
        tok["start_ts"][lanes] = t0 - 300
        tok["entry_ts"][lanes] = t0 - 300
    tb = EventBatch(ts=torch.full((1,), t0, dtype=torch.int64, device=dev),
                    kind=torch.full((1,), 2, dtype=torch.int8, device=dev),
                    valid=torch.ones(1, dtype=torch.bool, device=dev), cols={})
    timer_run = scan("K37 TIMER step over 1,024 slots", ppa, P, tok, tb,
                     torch.full((1,), P, dtype=torch.int32, device=dev),
                     torch.ones(P, dtype=torch.bool, device=dev), sid=None)
    if int(timer_run["want"][2].sum()) != 3 * len(due):
        raise AssertionError("K37 TIMER step: the due deadlines did not all emit")

    # ---- ragged shapes and edge cases --------------------------------------
    fast_q = "every e1=S[price > 90] -> e2=S[price < 10] within 20 milliseconds"
    for bb, pp, tt in ((33, 5, 4), (513, 33, 8)):
        qr = query(fast_q, tt, pp, bb, "e1.symbol as s, e1.price as p1, e2.price as p2")
        b2, s2 = batch(bb, pp, dense=True, timer=0.05)
        chunk_route(f"fast ragged B={bb}", qr, pp, table(qr, pp, 0.4), b2, s2)
        qc = query("every e1=S[price > 90]<2:4> -> e2=S[price < 10] -> e3=S[volume > e2.volume]",
                   tt, pp, bb, "e1[0].price as p0, e3.volume as v")
        chunk_route(f"count + tail ragged B={bb}", qc, pp, table(qc, pp, 0.4, count=True), b2,
                    s2)
        qs = query("every e1=S[price > 50], e2=S[price < 50], e3=S[price > 20]", tt, pp, bb,
                   "e1.symbol as s, e3.price as p3")
        chunk_route(f"sequence ragged B={bb}", qs, pp, table(qs, pp), b2, s2)
        qa = query("every e1=S[price > 90] -> not S[price < 10] for 5 milliseconds and "
                   "e2=S[volume > 500]", tt, pp, bb, "e1.symbol as s")
        scan(f"K37 ragged B={bb}", qa, pp, table(qa, pp, 0.4), b2, s2,
             torch.from_numpy(rng.random(pp) < 0.9).to(dev),
             seen=torch.full((pp,), t0, dtype=torch.int64, device=dev))
    # one slot's run of rows across every chunk
    qr = query(fast_q, 8, 3, 64, "e1.symbol as s")
    b2, s2 = batch(64 * 4, 3, dense=True, one_slot=1)
    chunk_route("one slot across chunks", qr, 3, table(qr, 3), b2, s2)
    # the fork runs out of one slot's lanes; the other slots fit
    qr = query("every e1=S[price > 50] -> e2=S[price < 0]", 16, 4, 64, "e1.symbol as s")
    tok = table(qr, 4, 0.2, virgin=0.0)
    tok["active"][16:32] = True
    tok["slot"][16:32] = torch.where(torch.arange(16, device=dev) == 0, 0, 1).to(torch.int32)
    b2, s2 = batch(64, 4, dense=True)
    chunk_route("fork overflow in slot 1 only", qr, 4, tok, b2, s2, want_overflow=True)
    # an emission stretch of 2 rows in slot 0, which completes more
    qr = query("every e1=S[price > 50] -> e2=S[price < 50]", 16, 4, 64, "e1.symbol as s")
    tok = table(qr, 4, 0.9, virgin=0.0)
    tok["slot"][:16] = torch.where(torch.arange(16, device=dev) == 0, 0, 1).to(torch.int32)
    b2, s2 = batch(64, 4, dense=True)
    chunk_route("emission overflow in slot 0 only", qr, 4, tok, b2, s2,
                emis_caps=lambda c: torch.where(torch.arange(4, device=dev) == 0, 2, c),
                want_overflow=True)
    # a cross-ref [P*T, C] condition; two streams on one key table
    qr = query("every e1=S[price > 50] -> e2=S[price < e1.price]", 8, 33, 513, "e1.symbol as s")
    b2, s2 = batch(513, 33)
    chunk_route("cross-ref condition", qr, 33, table(qr, 33), b2, s2)
    qr = query("every e1=S[price > 50] -> e2=S2[price < 50]", 8, 33, 513, "e1.symbol as s")
    chunk_route("two streams (S2's step)", qr, 33, table(qr, 33), b2, s2, sid="S2")
    chunk_route("two streams (S's step)", qr, 33, table(qr, 33), b2, s2, sid="S")
    qr = query("e1=S[price > 50] -> not S2[price < 50] for 5 milliseconds", 8, 33, 513,
               "e1.symbol as s")
    scan("K37 two streams (S2's step)", qr, 33, table(qr, 33), b2, s2,
         torch.ones(33, dtype=torch.bool, device=dev), sid="S2")
    # an emission stretch of 1 row in every slot (the step runs again larger)
    qr = query("every e1=S[price > 50] -> e2=S[price < 50]", 16, 4, 64, "e1.symbol as s")
    qr._scan = True
    qr.prog.compile_scan()
    b2, s2 = batch(64, 4, dense=True)
    scan("K37 stretches of one row", qr, 4, table(qr, 4, 0.9), b2, s2,
         torch.ones(4, dtype=torch.bool, device=dev),
         caps=torch.ones(4, dtype=torch.int64, device=dev))

    # ---- times at the paths' shapes -----------------------------------------
    # ms: the device time of a wrapper's kernels alone (torch.profiler);
    # wrapper_ms: the wrapper's call with its host work (CUDA events);
    # bound_ms: the bytes the call must move over the memory rate: each
    # element it changes written once; read once: the control lanes (active,
    # slot) of every token of a partition slot it runs, the other lanes it
    # needs only of the tokens it acts on, its rows and its list entries
    def chunk_time(run, name, q=None, i=3):
        """K34 (NFA slot q's pass), K35 or K36 on chunk i of a path's
        shape, from the table the chunk's earlier passes leave (the path's
        own order, `keyed_chunk`, with the plain versions)."""
        qr, Pn, ch, inputs, now = run["qr"], run["P"], run["ch"], run["inputs"], run["now"]
        prog = qr.prog
        T, S, C = prog.T, len(prog.slots), ch.C
        st = St(clone(run["tok"]), torch.full((Pn * T,), -1, dtype=torch.int32, device=dev),
                PM.keyed_out(prog, run["caps"], qr.out_cap),
                torch.zeros((), dtype=torch.bool, device=dev))
        grab = {}

        class Reached(Exception):
            pass

        def hook(key):
            def call(*a, **kw):
                if key == name and (key != k34 or a[1] == q):
                    grab.update(args=a, kw=kw)
                    raise Reached
                plain_fn[key](*a, **kw)

            return call

        try:
            qr.keyed_chunk(i, st.tok, st.er, ch, inputs, st.emis, now, st.ovf,
                           impl={"advance": hook(k34), "count": hook(k35), "emit": hook(k36)})
            raise AssertionError(f"{name} is not run in chunk {i}")
        except Reached:
            pass
        pre = [clone(st.tok), st.er.clone(), st.emis.n.clone(),
               {k_: v_.clone() for k_, v_ in st.emis.out.items()}, st.ovf.clone()]
        cur = [st.tok, st.er, st.emis.n, st.emis.out, st.ovf]

        def setup():
            for d, src in zip(flat(cur), flat(pre), strict=True):
                d.copy_(src)

        def call(f):
            f(*grab["args"], **grab["kw"])

        ms = device_ms(torch, setup, lambda: call(kernel_fn[name]), 20, PP_DEVICE_NAMES[name])
        wrapper = time_inplace(torch, setup, lambda: call(kernel_fn[name]), 20)
        setup()
        t = time.perf_counter()
        call(plain_fn[name])
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t) * 1e3
        setup()
        call(kernel_fn[name])
        torch.cuda.synchronize()
        written = changed_bytes(torch, pre[:4], cur[:4])
        emitted = changed_bytes(torch, pre[3], cur[3])
        # what it reads: the segments of chunk i, their slots' control lanes,
        # the rows (list entry, timestamp, condition or masks, the captured
        # columns) and the acted-on tokens' other lanes
        cb, nseg = i * C, int(ch.nseg[i])
        live = torch.zeros(Pn, dtype=torch.bool, device=dev)
        live[ch.seg_slot[cb:cb + nseg].long()] = True
        live = live.repeat_interleave(T)
        act, sl = pre[0]["active"] & live, pre[0]["slot"]
        n_rows = int((ch.seg_hi[cb:cb + nseg] - ch.seg_lo[cb:cb + nseg]).sum())
        evs = inputs["evs"]

        def col_b(qq):
            cc = pre[0]["caps"][prog.slots[qq].atoms[0].ref_idx]["cols"]
            return sum(evs[qq][n_].element_size() for n_ in cc) if evs[qq] is not None else 0

        read = int(live.sum()) * (1 + 4) + nseg * 12 + 4 + n_rows * (4 + 8)
        if name == k34:
            cond = grab["args"][7]
            row_cond = cond is None or cond.dim() == 0 or cond.shape[0] == 1
            acted = int((act & (sl == q)).sum())
            read += acted * (4 + 8) + n_rows * (1 + col_b(q)) + (0 if row_cond
                                                                  else acted * n_rows)
        elif name == k35:
            read += int((act & (sl == 0)).sum()) * (4 + 8) + n_rows * (2 + col_b(0) + col_b(1))
        else:
            done = act & (sl == S)
            read += int(done.sum()) * 4 + emitted
            if grab["kw"].get("purge"):
                read += int((act & ~done).sum()) * 8
        bound = (read + written) / MEM_BYTES_PER_S * 1e3
        return ms, plain, bound, wrapper

    r = res[k34]
    r["ms"], r["plain_ms"], r["bound_ms"], r["wrapper_ms"] = chunk_time(ppf_run, k34, q=0)
    r["advance_ms"], _p, r["advance_bound_ms"], _w = chunk_time(ppf_run, k34, q=1)
    r = res[k36]
    r["ms"], r["plain_ms"], r["bound_ms"], r["wrapper_ms"] = chunk_time(ppf_run, k36)
    r = res[k35]
    r["ms"], r["plain_ms"], r["bound_ms"], r["wrapper_ms"] = chunk_time(ppc_run, k35)

    def scan_bound(run, new, emis) -> float:
        """K37's bytes: the control lanes of every token of each slot the
        step runs (used, with rows or TIMER rows), the other lanes of its
        active tokens, its rows (list entry, ts, kind, valid, row masks,
        registers, the captured columns) read once; the changed lanes, the
        emitted rows and the counts written."""
        tok, rows, Pn = run["tok"], run["rows"], run["used"].shape[0]
        T = run["prog"].T
        nt = int(rows.info[3])
        ran = run["used"] if nt else run["used"] & (rows.rows > 0)
        on = ran.repeat_interleave(T)
        full_b = sum(x.element_size() * (x.numel() // (Pn * T)) for x in flat(tok)) - (1 + 4)
        n_rows = int(rows.rows[ran].sum()) + nt * int(ran.sum())
        row_b = (4 + 8 + 1 + 1 + run["rmask"].shape[0] + 4 * len(run["regs"])
                 + sum(c.element_size() for c in run["ev"].values()))
        blank = run["prog"].init_out(emis.out["ts"].shape[0])
        nbytes = (int(on.sum()) * (1 + 4) + int((tok["active"] & on).sum()) * full_b
                  + n_rows * row_b + changed_bytes(torch, tok, new)
                  + changed_bytes(torch, blank, emis.out) + 4 * Pn)
        return nbytes / MEM_BYTES_PER_S * 1e3

    for run, key in ((ppa_run, "ms"), (timer_run, "timer_ms")):
        prog = run["prog"]
        args = (prog, run["tok"], run["sid"], run["bt"].ts, run["bt"].kind, run["bt"].valid,
                run["ev"], run["rmask"], run["regs"])
        last = {}

        def step(fn=PM.partition_pattern_scan, rows=run["rows"], run=run, args=args, last=last):
            emis = PM.keyed_out(prog, run["caps"], run["out_cap"])
            ovf = torch.zeros((), dtype=torch.bool, device=dev)
            last["new"], last["emis"] = fn(*args, rows, run["used"], emis, ovf, run["seen"]), emis

        res[k37][key] = device_ms(torch, lambda: None, step, 5, PP_DEVICE_NAMES[k37])
        res[k37]["wrapper_" + key] = time_ms(torch, step, 5)
        step()
        torch.cuda.synchronize()
        bound = scan_bound(run, last["new"], last["emis"])
        if key == "ms":
            res[k37]["plain_ms"] = time_once(torch, lambda: step(
                PM.partition_pattern_scan_ref, K.partition_rows_ref(run["bt"], slot_a, P)))
            res[k37]["bound_ms"] = bound
        else:
            res[k37]["timer_bound_ms"] = bound
    ch = ppf_run["ch"]
    r = res[kch]
    r["ms"] = device_ms(torch, lambda: None, lambda: K.pattern_chunks(ch.ts, ch.v, ch.slot,
                                                                      ch.C, P),
                        20, PP_DEVICE_NAMES[kch])
    r["wrapper_ms"] = time_ms(torch, lambda: K.pattern_chunks(ch.ts, ch.v, ch.slot, ch.C, P), 20)
    r["plain_ms"] = time_once(torch, lambda: K.pattern_chunks_ref(ch.ts, ch.v, ch.slot, ch.C, P))
    # rows read (member flag, slot) and listed; each slot's count; each
    # chunk's segments (slot, lo, hi) and their count
    r["bound_ms"] = (B * (1 + 4) + B * 4 + 4 * P + int(ch.nseg.sum()) * 12 + 4 * ch.k) \
        / MEM_BYTES_PER_S * 1e3
    # the library yardstick: one stable sort of the rows by (chunk, slot)
    key = torch.arange(B, device=dev) // ch.C * (P + 1) + ch.slot.long()
    r["library_ms"] = time_ms(torch, lambda: torch.sort(key, stable=True), 20)
    want = ppa_run["want"]
    emis = PM.keyed_out(ppa_run["prog"], ppa_run["caps"], ppa_run["out_cap"])
    for k_, v_ in want[1].items():
        emis.out[k_].copy_(v_)
    emis.n.copy_(want[2])
    r = res[kpl]

    def place():
        return K.pattern_place(emis.out, emis.off, emis.cap, emis.n, P)

    r["ms"] = device_ms(torch, lambda: None, place, 20, PP_DEVICE_NAMES[kpl])
    r["wrapper_ms"] = time_ms(torch, place, 20)
    r["plain_ms"] = time_once(torch, lambda: K.pattern_place_ref(emis.out, emis.off, emis.cap,
                                                                 emis.n, P))
    n_rows = int(torch.minimum(emis.n, emis.cap).sum())
    lane_b = sum(v.element_size() * (v.shape[1] if v.dim() == 2 else 1)
                 for v in emis.out.values())
    # each slot's offset, stretch and count read; each row's lanes read and
    # written, its slot and its slot's first row written
    r["bound_ms"] = (n_rows * (2 * lane_b + 4 + 4) + P * (8 + 4 + 4)) / MEM_BYTES_PER_S * 1e3
    # the row lists at the paths' batch (PPA's data step: 32,768 rows)
    r = res[kr]
    # its ms the whole call, device_ms its device work (device_all_ms), kernel_ms the profiler's
    r.update(three_times(torch, lambda: K.partition_rows(bt, slot, P), 20, PP_DEVICE_NAMES[kr]))
    r["wrapper_ms"] = r["ms"]
    r["plain_ms"] = time_once(torch, lambda: K.partition_rows_ref(bt, slot, P))
    n_tim = int(((bt.kind == 2) & bt.valid).sum())
    # kind, valid and slot read a row; the row list, the slot starts, the
    # TIMER rows and the counts written
    r["bound_ms"] = (B * (1 + 1 + 4) + B * 4 + 4 * (P + 1) + 4 * n_tim + 16) \
        / MEM_BYTES_PER_S * 1e3
    # the library yardstick: one stable sort of the rows by slot
    member = bt.valid & (bt.kind == 0) & (slot >= 0) & (slot < P)
    skey = torch.where(member, slot, P)
    lib = three_times(torch, lambda: torch.sort(skey, stable=True), 20, None)
    r["library_ms"], r["library_device_ms"] = lib["ms"], lib["device_ms"]
    r["library_kernel_ms"] = lib["kernel_ms"]
    for name in PP_KERNELS:
        r = res[name]
        r["bound_by"] = "bytes"
        r.setdefault("library_ms", None)
        lib = "None" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        if name == kr:
            print(f"kernel {name}: ms={r['ms']:.4f} (the whole call) device_ms="
                  f"{r['device_ms']:.4f} kernel_ms={fmt(r['kernel_ms'])} plain_ms="
                  f"{r['plain_ms']:.4f} bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) "
                  f"library_ms={lib} library_device_ms={r['library_device_ms']:.4f} "
                  f"library_kernel_ms={fmt(r['library_kernel_ms'])} checks={r['checks']} exact",
                  flush=True)
            continue
        print(f"kernel {name}: ms={r['ms']:.4f} (device, torch.profiler; with the wrapper's "
              f"host work {r['wrapper_ms']:.4f}) plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) library_ms={lib} "
              f"checks={r['checks']} exact", flush=True)
    print(f"kernel partition_pattern_advance (advance at slot 1): {res[k34]['advance_ms']:.4f} ms"
          f" (bound {res[k34]['advance_bound_ms']:.6f}); partition_pattern_scan TIMER step: "
          f"{res[k37]['timer_ms']:.4f} ms (bound {res[k37]['timer_bound_ms']:.6f}, with the "
          f"wrapper {res[k37]['wrapper_timer_ms']:.4f})", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 3: verify cases against VERIFY.json
# ---------------------------------------------------------------------------


PJ_KERNEL_NAMES = ("partition_ring_view", "partition_join_assemble", "partition_sort_window_step",
                   "partition_frequent_window_step")
PJ_W, PSW_N, PFQ_N = 50, 10, 10


def keyed_ring(torch, rng, dev, p: int, w: int, vmax: int = 1000, holes: float = 0.0,
               lanes=None) -> dict:
    """P sliding rings of W slots for K38 (a partitioned join side): slot q
    holds the last of total[q] seqs (in ring order, or scattered with `holes`
    a share of them gone), the rest -1; the stock lanes, or `lanes` int32 /
    bool lanes."""

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    total = rng.integers(0, 3 * w + 1, p)
    seq = np.full((p, w), -1, np.int64)
    for q in range(p):
        live = np.arange(max(0, total[q] - w), total[q])
        live = live[rng.random(live.shape[0]) >= holes]
        pos = live % w if holes == 0 else rng.permutation(w)[:live.shape[0]]
        seq[q, pos] = live
    if lanes is not None:  # `lanes` int32 / bool lanes (past one launch's 32)
        cols = {f"c{i}": t(rng.random((p, w)) < 0.5 if i % 3 == 0
                           else rng.integers(-9, 9, (p, w)).astype(np.int32))
                for i in range(lanes)}
    else:
        cols = {"symbol": t(rng.integers(1, 9, (p, w)).astype(np.int32)),
                "price": t(rng.uniform(0, 100, (p, w)).astype(np.float32)),
                "volume": t(rng.integers(1, vmax, (p, w)).astype(np.int64))}
    return {"cols": cols,
            "ts": t(rng.integers(0, 10**9, (p, w)).astype(np.int64)),
            "wts": t(np.zeros((p, w), np.int64)), "seq": t(seq),
            "total": t(total.astype(np.int64))}


def partition_join_kernel_phase(torch, dev) -> dict:
    """The join slice's keyed kernels against their plain versions on the
    card, bit for bit on every output lane, state lane and flag, from the
    same inputs: the keyed ring view K38 and the keyed probe compaction K39
    at path PJ's shape (P=1024 rings of W=50, 32,768 probe rows of 1,000
    keys, joinCapacity 512 a slot, an equality `on` over the slot's view)
    with inner and outer joins, EXPIRED probes, a unidirectional side (an
    empty probe set), a self-join (probes and view from one stream), one
    slot overflowing its capacity, empty slots and keys past capacity, and
    K38 alone at W 32/33/64/65/1,024/1,025 (its groups of 32-1,024
    threads a slot), empty and holed rings, 40 lanes (two launches) and W
    57,345 (the global scratch), and
    ragged B/P/W; the keyed sort window K40 at path PSW's shape (B=32768,
    P=1024, sort(10, price desc, volume asc), carried state) with NaN and
    -0.0 keys and one to four comparators; the keyed frequent window K41 at
    path PFQ's shape (frequent(10, volume)) with -0.0/0.0 keys (a price
    key) and a call bringing more than N new keys to one slot; then each
    kernel's time beside its plain version's, its byte bound and the
    library call named in PERF.md."""
    from siddhi_tpu_torch.core.event import EventBatch
    from siddhi_tpu_torch.core.types import AttrType
    from siddhi_tpu_torch.core.windows_special import _key_col
    from siddhi_tpu_torch.ops import partition as K

    k38, k39, k40, k41 = PJ_KERNEL_NAMES
    res = {k: {"max_abs_err": 0.0, "checks": 0} for k in PJ_KERNEL_NAMES}
    rng = np.random.default_rng(1038)
    attrs = [("symbol", AttrType.STRING), ("price", AttrType.FLOAT), ("volume", AttrType.LONG)]
    types = dict(attrs)
    traps = np.concatenate([np.array([np.nan, -0.0, 0.0, 1.5, 2.5, -3.0], np.float32),
                            SUBNORMALS])

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def ring(p, w, vmax=1000, holes=0.0, lanes=None):
        return keyed_ring(torch, rng, dev, p, w, vmax, holes, lanes)

    def check_view(state):
        got, want = K.partition_ring_view(state), K.partition_ring_view_ref(state)
        torch.cuda.synchronize()
        same_bits(torch, got, want)
        res[k38]["checks"] += 1
        return want

    def probes(b, p, vmax=1000, kind=0, past=0.0, keys=None, trap=False):
        slot = rng.integers(0, p, b) if keys is None else keys
        slot = np.where(rng.random(b) < past, p, slot)
        return {"slot": t(slot.astype(np.int32)), "ts": t(np.arange(b, dtype=np.int64)),
                "kind": t(np.full(b, kind, np.int8)),
                "mask": t(rng.random(b) < (0.9 if trap else 1.0)),
                "cols": {"symbol": t(rng.integers(1, 9, b).astype(np.int32)),
                         "price": t(rng.uniform(0, 100, b).astype(np.float32)),
                         "volume": t(rng.integers(1, vmax, b).astype(np.int64))}}

    def cat(parts):
        return {"slot": torch.cat([x["slot"] for x in parts]),
                "ts": torch.cat([x["ts"] for x in parts]),
                "kind": torch.cat([x["kind"] for x in parts]),
                "mask": torch.cat([x["mask"] for x in parts]),
                "cols": {n: torch.cat([x["cols"][n] for x in parts]) for n in parts[0]["cols"]}}

    def assemble_args(pr, view, p, outer, cap, on=True):
        vcols, vts, vmask = view
        at = pr["slot"].long().clamp(0, p - 1)
        pair = pr["mask"][:, None] & vmask[at]
        if on:
            pair = pair & (pr["cols"]["volume"][:, None] == vcols["volume"][at])
        return (pair, pr["mask"], pr["slot"], outer, cap, p, pr["ts"], pr["kind"], pr["cols"],
                vts, vcols, types)

    def jlanes(r):
        return [r.ts, r.kind, r.valid, r.probe_cols, r.partner_cols, r.partner_ts, r.slot,
                r.first, r.overflow]

    def check_join(args):
        got = K.partition_join_assemble(*args)
        want = K.partition_join_assemble_ref(*args)
        torch.cuda.synchronize()
        same_bits(torch, jlanes(got), jlanes(want))
        res[k39]["checks"] += 1
        return want

    # path PJ's shape: 1,000 keys in 1,024 slots, rings of 50
    b, p, w, cap = MAIN_BATCH, PT_CAP, PJ_W, 512
    keys = rng.integers(0, PT_SYMBOLS, b)
    pj_ring = ring(p, w)
    pj_view = check_view(pj_ring)
    pj_probes = probes(b, p, keys=keys)
    pj_args = assemble_args(pj_probes, pj_view, p, False, cap)
    pj_want = check_join(pj_args)
    check_join(assemble_args(pj_probes, pj_view, p, True, cap))  # outer
    exp = probes(2 * b, p, kind=1, keys=rng.integers(0, PT_SYMBOLS, 2 * b), trap=True)
    for outer in (False, True):  # CURRENT then EXPIRED probes
        check_join(assemble_args(cat([pj_probes, exp]), pj_view, p, outer, cap))
    empty = probes(1, p, past=1.0)  # a unidirectional side: no probe row
    empty["mask"] = torch.zeros_like(empty["mask"])
    for outer in (False, True):
        check_join(assemble_args(empty, pj_view, p, outer, cap))
    # a self-join: the view is the probes' own stream's ring
    self_ring = ring(p, w, vmax=50)
    self_view = check_view(self_ring)
    check_join(assemble_args(probes(b, p, vmax=50, keys=keys), self_view, p, False, cap))
    # one slot overflowing its capacity: 600 rows of slot 3 match everything
    hot = probes(600, 8, keys=np.full(600, 3))
    hot_view = check_view(ring(8, 4))
    for outer in (False, True):
        if not bool(check_join(assemble_args(hot, hot_view, 8, outer, 512, on=False)).overflow):
            raise AssertionError("partition_join_assemble: the hot slot did not overflow")
    # empty slots, keys past capacity (probe rows of slot P in the mask)
    sparse_view = check_view(ring(33, 4, vmax=5, holes=0.3))
    for outer in (False, True):
        check_join(assemble_args(probes(513, 33, vmax=5, keys=rng.integers(0, 5, 513),
                                        past=0.1, trap=True), sparse_view, 33, outer, 7))
    # ragged B / P / W, rings with holes
    for bb, pp, ww in ((1, 1, 1), (33, 8, 4), (4097, 33, 50), (33, 1, 50), (4097, 1, 1),
                       (1, 33, 4)):
        view = check_view(ring(pp, ww, vmax=6, holes=0.2))
        for outer in (False, True):
            check_join(assemble_args(probes(bb, pp, vmax=6, past=0.05, trap=True), view, pp,
                                     outer, 5))
    # K38 alone: a group of 32 to 1,024 threads a slot (W 1/32/33/64/65/
    # 1,024/1,025), empty and holed rings, a ring of 40 lanes (two
    # launches) and W past shared memory (the global scratch)
    for pp, ww, kw in ((1024, 32, {}), (33, 33, dict(holes=0.3)), (1024, 64, {}),
                       (33, 65, dict(holes=0.5)), (8, 1024, dict(holes=0.2)), (8, 1025, {}),
                       (33, 50, dict(holes=1.0)), (1, 1, dict(holes=1.0)),
                       (33, 16, dict(holes=0.2, lanes=40)), (2, 57_345, dict(holes=0.3))):
        check_view(ring(pp, ww, **kw))
    print(f"partition join kernels: {res[k38]['checks']} K38 and {res[k39]['checks']} K39 "
          "checks bit for bit", flush=True)

    # ---- K40 / K41
    def windows(kind, p, n):
        z = lambda dt: torch.zeros((p, n), dtype=dt, device=dev)  # noqa: E731
        st = {"cols": {"symbol": z(torch.int32), "price": z(torch.float32),
                       "volume": z(torch.int64)},
              "ts": z(torch.int64), "occ": z(torch.bool)}
        if kind == "sort":
            st.update(seq=z(torch.int64), next=torch.zeros(p, dtype=torch.int64, device=dev))
        else:
            st.update(key=z(torch.int64), cnt=z(torch.int32))
        return st

    def wbatch(bsz, p, t0, trap=False, keys=None, vmax=1000):
        kind = np.where(rng.random(bsz) < 0.05, 2, np.where(rng.random(bsz) < 0.03, 1, 0)) \
            if trap else np.zeros(bsz)
        slot = rng.integers(0, p, bsz) if keys is None else keys
        if trap:
            slot = np.where(rng.random(bsz) < 0.05, p, slot)
        price = traps[rng.integers(0, len(traps), bsz)] if trap else rng.uniform(0, 100, bsz)
        batch = EventBatch(
            ts=t(t0 + np.arange(bsz, dtype=np.int64)), kind=t(kind.astype(np.int8)),
            valid=t(rng.random(bsz) < 0.9 if trap else np.ones(bsz, bool)),
            cols={"symbol": t(rng.integers(1, 9, bsz).astype(np.int32)),
                  "price": t(price.astype(np.float32)),
                  "volume": t(rng.integers(1, vmax, bsz).astype(np.int64))})
        return batch, t(slot.astype(np.int32))

    def wlanes(r):
        st, out, out_slot, out_first, ovf = r
        return [st, out.ts, out.kind, out.valid, out.cols, out_slot, out_first, ovf]

    def check_sort(st, batch, slot, now, sk, n, p):
        got = K.partition_sort_window_step(st, batch, slot, now, sk, n, p)
        want = K.partition_sort_window_step_ref(st, batch, slot, now, sk, n, p)
        torch.cuda.synchronize()
        same_bits(torch, wlanes(got), wlanes(want))
        res[k40]["checks"] += 1
        return want[0]

    def fkey(batch, ka):
        return _key_col(batch.cols, attrs, ka).expand(batch.ts.shape).contiguous()

    def check_freq(st, batch, slot, now, ka, n, p):
        key = fkey(batch, ka)
        got = K.partition_frequent_window_step(st, batch, key, slot, now, n, p)
        want = K.partition_frequent_window_step_ref(st, batch, key, slot, now, n, p)
        torch.cuda.synchronize()
        same_bits(torch, wlanes(got), wlanes(want))
        res[k41]["checks"] += 1
        return want[0]

    psw_keys = [("price", True), ("volume", False)]
    now = torch.tensor(7, dtype=torch.int64, device=dev)
    st_s, st_f = windows("sort", p, PSW_N), windows("freq", p, PFQ_N)
    for i in range(3):  # paths PSW's and PFQ's shapes, carried state
        batch, slot = wbatch(b, p, i * b, keys=rng.integers(0, PT_SYMBOLS, b))
        if i < 2:
            st_s = check_sort(st_s, batch, slot, now, psw_keys, PSW_N, p)
            st_f = check_freq(st_f, batch, slot, now, ["volume"], PFQ_N, p)
    psw = dict(state=st_s, batch=batch, slot=slot)
    pfq = dict(state=st_f, batch=batch, slot=slot)
    check_sort(st_s, batch, slot, now, psw_keys, PSW_N, p)
    check_freq(st_f, batch, slot, now, ["volume"], PFQ_N, p)
    for sk in ([("price", False)], psw_keys, [("price", True), ("volume", False),
                                              ("symbol", True)],
               [("volume", True), ("price", False), ("symbol", False), ("price", True)]):
        for bb, pp, nn in ((1, 1, 1), (33, 8, 3), (513, 33, 4), (4097, 8, 16)):
            st = windows("sort", pp, nn)
            for i in range(3):
                batch, slot = wbatch(bb, pp, i * bb, trap=True)
                st = check_sort(st, batch, slot, now + i, sk, nn, pp)
    for ka in (["volume"], ["price"], ["symbol", "volume"]):
        for bb, pp, nn in ((1, 1, 1), (33, 8, 3), (513, 33, 4), (4097, 8, 16)):
            st = windows("freq", pp, nn)
            for i in range(3):
                batch, slot = wbatch(bb, pp, i * bb, trap=True, vmax=6)
                st = check_freq(st, batch, slot, now + i, ka, nn, pp)
    # more than N new keys a call in one slot (every count decremented,
    # zeros evicted in slot order), then the same keys again
    st = windows("freq", 4, 4)
    for i in range(3):
        batch, slot = wbatch(513, 4, i * 513, keys=np.zeros(513, np.int64), vmax=40)
        st = check_freq(st, batch, slot, now, ["volume"], 4, 4)
    print(f"partition window kernels: {res[k40]['checks']} K40 and {res[k41]['checks']} K41 "
          "checks bit for bit", flush=True)

    # ---- times at the paths' shapes
    col_b = 4 + 4 + 8
    r = res[k38]
    # three ways (`three_times`), beside the argsort alone (part of the
    # function: the order) and the whole function as stock calls (the
    # argsort and a gather a lane, as partition_ring_view_ref)
    r.update(three_times(torch, lambda: K.partition_ring_view(pj_ring), 100, ("view_kernel(",)))
    r["plain_ms"] = time_once(torch, lambda: K.partition_ring_view_ref(pj_ring))
    seq = pj_ring["seq"]
    skey = torch.where(seq >= 0, seq, np.iinfo(np.int64).max)
    r["library"] = three_times(torch, lambda: torch.argsort(skey, dim=1, stable=True), 100,
                               None)
    r["library_ms"] = r["library"]["ms"]
    view_lanes = [*pj_ring["cols"].values(), pj_ring["ts"]]

    def whole():
        perm = torch.argsort(skey, dim=1, stable=True)
        return [torch.gather(x, 1, perm) for x in view_lanes] + [torch.gather(seq >= 0, 1, perm)]

    r["library_whole"] = three_times(torch, whole, 100, None)
    r["bound_ms"], r["bound_by"] = (p * w * (8 + 2 * (8 + col_b) + 1) + 8 * p) \
        / MEM_BYTES_PER_S * 1e3, "bytes"
    print(f"kernel partition_ring_view P={p} W={w}: ms={r['ms']:.4f} "
          f"device_ms={r['device_ms']:.4f} kernel_ms={fmt(r['kernel_ms'])}; stable argsort "
          f"{r['library']['ms']:.4f}/{r['library']['device_ms']:.4f}/"
          f"{fmt(r['library']['kernel_ms'])}; argsort + a gather a lane "
          f"{r['library_whole']['ms']:.4f}/{r['library_whole']['device_ms']:.4f}/"
          f"{fmt(r['library_whole']['kernel_ms'])}", flush=True)
    r = res[k39]
    pair = pj_args[0]
    r["ms"] = time_ms(torch, lambda: K.partition_join_assemble(*pj_args), 20)
    r["plain_ms"] = time_once(torch, lambda: K.partition_join_assemble_ref(*pj_args))
    r["library_ms"] = time_ms(torch, lambda: torch.nonzero(pair), 20)
    rows = int(pj_want.valid.sum())
    r["rows"] = rows
    # the bytes touched: the pair mask, each probe row's mask and slot, and
    # for the rows out only, the probe lanes (ts, kind, columns) and the
    # partner lanes (ts, columns) read through the gathers and every output
    # lane written (ts, kind, valid, both sides' columns, partner ts, slot,
    # first row); the flag
    n_r, n_w = pair.shape
    r["bound_ms"], r["bound_by"] = (n_r * n_w + n_r * (1 + 4)
                                    + rows * ((8 + 1 + col_b) + (8 + col_b)
                                              + (8 + 1 + 1 + 2 * col_b + 8 + 4 + 4)) + 1) \
        / MEM_BYTES_PER_S * 1e3, "bytes"
    for name, d, step, ref, extra in (
            (k40, psw, K.partition_sort_window_step, K.partition_sort_window_step_ref,
             (psw_keys, PSW_N, p)),
            (k41, pfq, K.partition_frequent_window_step, K.partition_frequent_window_step_ref,
             (PFQ_N, p))):
        st, batch, slot = d["state"], d["batch"], d["slot"]
        if name == k41:
            key = fkey(batch, ["volume"])
            args = (st, batch, key, slot, now) + extra
            state_b = p * PFQ_N * (col_b + 8 + 1 + 8 + 4)
        else:
            args = (st, batch, slot, now) + extra
            state_b = p * PSW_N * (col_b + 8 + 1 + 8) + 8 * p
        r = res[name]
        r["ms"] = time_ms(torch, lambda: step(*args), 20)
        r["plain_ms"] = time_once(torch, lambda: ref(*args))
        r["library_ms"] = None
        out = ref(*args)[1]
        n_out = int(out.valid.sum())
        r["rows"] = n_out
        r["bound_ms"], r["bound_by"] = (b * (8 + 1 + 1 + 4 + col_b + (8 if name == k41 else 0))
                                        + 2 * state_b + n_out * (8 + 1 + 1 + col_b + 4 + 4)) \
            / MEM_BYTES_PER_S * 1e3, "bytes"
    for name in PJ_KERNEL_NAMES:
        r = res[name]
        print(f"kernel {name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) library_ms={r['library_ms']} "
              f"checks={r['checks']} exact", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 2, the lossyFrequent and cron windows inside a partition (K42, K43)
# and the incremental aggregation (K44, K45)
# ---------------------------------------------------------------------------

PSP_KERNEL_NAMES = ("partition_lossy_frequent_window_step", "partition_cron_window_step")
PLF_S, PLF_E = 0.1, 0.01  # path PLF's lossyFrequent(0.1, 0.01, volume): 400 key slots
PCR_W = 1024  # a cron window's slots (the time capacity)


def _slot_tree(torch, dev, p, w, lanes: dict, cols=True):
    """A [P, w] state tree of zeros: the three stock columns (under
    "cols", or cur_cols/prev_cols) and the named lanes."""
    z = lambda dt: torch.zeros((p, w), dtype=dt, device=dev)  # noqa: E731
    col = lambda: {"symbol": z(torch.int32), "price": z(torch.float32),  # noqa: E731
                   "volume": z(torch.int64)}
    st = {"cols": col()} if cols else {"cur_cols": col(), "prev_cols": col()}
    for name, (shape, dt) in lanes.items():
        st[name] = torch.zeros((p,) if shape == "p" else (p, w), dtype=dt, device=dev)
    return st


def partition_special_kernel_phase(torch, dev) -> dict:
    """The keyed lossyFrequent (K42) and cron (K43) windows against their
    plain versions on the card, bit for bit on every output lane, slot and
    first row, every state lane and the flag, from the same inputs and
    carried state: K42 at path PLF's shape (B=32768, P=1024, 1,000 keys,
    lossyFrequent(0.1, 0.01, volume): 400 key slots a partition in shared
    memory) over three carried batches, ragged B 1/33/513 and P 1/33 with
    NaN/-0.0 price keys, TIMER, EXPIRED and invalid rows and keys past
    capacity, a slot's table full one row before its bucket end (a new key
    lost, then the prune of every key), and key tables in global scratch
    (4,000 slots: lossyFrequent(0.002, 0.001)); K43 at path PCR's shapes (a
    one-second bucket of 1,000 events in a 32,768-row batch over P=1024,
    w=1024, then a one-row TIMER batch over every slot), TIMER rows anywhere
    in ragged batches (B 1/33/513, P 1/33, w 4/16), buckets past their w
    slots; then each kernel's time beside its plain version's and its byte
    bound."""
    from siddhi_tpu_torch.core.event import EventBatch
    from siddhi_tpu_torch.ops import partition as K

    k42, k43 = PSP_KERNEL_NAMES
    res = {k: {"max_abs_err": 0.0, "checks": 0, "library_ms": None} for k in PSP_KERNEL_NAMES}
    rng = np.random.default_rng(1042)
    traps = np.concatenate([np.array([np.nan, -0.0, 0.0, 1.5, 2.5, -3.0], np.float32),
                            SUBNORMALS])

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def pbatch(b, p, t0, trap=False, keys=None, vmax=1000, n_valid=None, timer_at=()):
        kind = np.where(rng.random(b) < 0.05, 2, np.where(rng.random(b) < 0.03, 1, 0)) \
            if trap else np.zeros(b)
        kind = kind.astype(np.int8)
        for i in timer_at:
            kind[i] = 2
        slot = rng.integers(0, p, b) if keys is None else keys
        if trap:
            slot = np.where(rng.random(b) < 0.05, p, slot)
        valid = rng.random(b) < 0.9 if trap else np.ones(b, bool)
        if n_valid is not None:
            valid[n_valid:] = False
        price = traps[rng.integers(0, len(traps), b)] if trap else rng.uniform(0, 100, b)
        batch = EventBatch(
            ts=t(t0 + np.arange(b, dtype=np.int64)), kind=t(kind), valid=t(valid),
            cols={"symbol": t(rng.integers(1, 9, b).astype(np.int32)),
                  "price": t(price.astype(np.float32)),
                  "volume": t(rng.integers(1, vmax, b).astype(np.int64))})
        return batch, t(np.asarray(slot).astype(np.int32))

    def lanes(r):
        st, out, out_slot, out_first, ovf = r
        return [st, out.ts, out.kind, out.valid, out.cols, out_slot, out_first, ovf]

    def lossy_state(p, c):
        i64 = ("pw", torch.int64)
        return _slot_tree(torch, dev, p, c, {"ts": i64, "occ": ("pw", torch.bool), "key": i64,
                                             "cnt": i64, "bucket": i64,
                                             "total": ("p", torch.int64)})

    def lossy_args(s, e):
        return max(64, int(4.0 / e)), max(1, int(1.0 / e + 0.9999999)), s, e

    def checked(name, fn, ref, args, timed):
        """The kernel against its plain version (the plain one timed once
        when `timed`: at the path's shape); returns the plain output."""
        got = fn(*args)
        if timed:
            out = []
            res[name]["plain_ms"] = time_once(torch, lambda: out.append(ref(*args)))
            want = out[0]
        else:
            want = ref(*args)
        torch.cuda.synchronize()
        same_bits(torch, lanes(got), lanes(want))
        res[name]["checks"] += 1
        return want

    def check_lossy(st, batch, slot, now, s, e, p, key_col="volume", timed=False):
        c, width, s, e = lossy_args(s, e)
        key = (batch.cols[key_col] if key_col == "volume"
               else batch.cols["price"].view(torch.int32).to(torch.int64)).contiguous()
        args = (st, batch, key, slot, now, c, width, s, e, p)
        return checked(k42, K.partition_lossy_frequent_window_step,
                       K.partition_lossy_frequent_window_step_ref, args, timed), args

    b, p = MAIN_BATCH, PT_CAP
    now = torch.tensor(7, dtype=torch.int64, device=dev)
    c_plf = lossy_args(PLF_S, PLF_E)[0]
    # path PLF's shape, on a state the kernel carried over a first batch
    # (its plain version takes ~10 s here: one call, timed)
    st = lossy_state(p, c_plf)
    batch, slot = pbatch(b, p, 0, keys=rng.integers(0, PT_SYMBOLS, b))
    st = K.partition_lossy_frequent_window_step(
        st, batch, batch.cols["volume"], slot, now, *lossy_args(PLF_S, PLF_E), p)[0]
    batch, slot = pbatch(b, p, b, keys=rng.integers(0, PT_SYMBOLS, b))
    want, plf_args = check_lossy(st, batch, slot, now, PLF_S, PLF_E, p, timed=True)
    plf_rows = int(want[1].valid.sum())
    for s_, e_, key_col in ((0.3, 0.1, "volume"), (0.5, 0.25, "price")):
        for bb, pp in ((1, 1), (33, 33), (513, 1), (513, 33), (33, 1)):
            st = lossy_state(pp, lossy_args(s_, e_)[0])
            for i in range(3):
                batch, slot = pbatch(bb, pp, i * bb, trap=True, vmax=6)
                st = check_lossy(st, batch, slot, now + i, s_, e_, pp, key_col)[0][0]
    # slot 2's table full one row before its bucket end (width 4, 64 slots)
    st = lossy_state(4, 64)
    st["occ"][2] = True
    st["key"][2] = torch.arange(10**6, 10**6 + 64, device=dev)
    st["cnt"][2] = 1
    st["total"][2] = 3
    for i in range(2):
        batch, slot = pbatch(33, 4, i * 33, keys=np.full(33, 2))
        want, _a = check_lossy(st, batch, slot, now, 0.26, 0.25, 4)
        st = want[0]
        if i == 0 and not (bool(want[4]) and int((want[1].kind == 1).sum()) >= 64):
            raise AssertionError("K42: the full table lost no key or pruned fewer than 64")
    # key tables past shared memory: 4,000 slots a partition, global scratch
    st = lossy_state(8, 4000)
    for i in range(2):
        batch, slot = pbatch(4097, 8, i * 4097)
        st = check_lossy(st, batch, slot, now, 0.002, 0.001, 8)[0][0]
    print(f"partition lossyFrequent kernel: {res[k42]['checks']} K42 checks bit for bit",
          flush=True)

    # ---- K43
    def cron_state(p, w):
        i32 = ("p", torch.int32)
        return _slot_tree(torch, dev, p, w, {"cur_ts": ("pw", torch.int64), "cur_n": i32,
                                             "prev_ts": ("pw", torch.int64), "prev_n": i32},
                          cols=False)

    def check_cron(st, batch, slot, now, w, p, timed=False):
        args = (st, batch, slot, now, w, p)
        return checked(k43, K.partition_cron_window_step, K.partition_cron_window_step_ref,
                       args, timed), args

    st = cron_state(p, PCR_W)
    timer = EventBatch(ts=t(np.array([10**6], np.int64)), kind=t(np.array([2], np.int8)),
                       valid=t(np.array([True])),
                       cols={"symbol": t(np.zeros(1, np.int32)),
                             "price": t(np.zeros(1, np.float32)),
                             "volume": t(np.zeros(1, np.int64))})
    # path PCR's shapes: a one-second bucket, then a fire over every slot
    batch, slot = pbatch(b, p, 0, keys=rng.integers(0, PT_SYMBOLS, b), n_valid=CR_BUCKET)
    want, pcr_data_args = check_cron(st, batch, slot, now, PCR_W, p, timed=True)
    data_plain_ms = res[k43]["plain_ms"]
    want, pcr_timer_args = check_cron(want[0], timer, t(np.array([p], np.int32)), now, PCR_W,
                                      p, timed=True)
    res[k43]["timer_plain_ms"], res[k43]["plain_ms"] = res[k43]["plain_ms"], data_plain_ms
    pcr_rows = int(want[1].valid.sum())
    if pcr_rows < CR_BUCKET:
        raise AssertionError(f"K43: a fire over {p} slots flushed {pcr_rows} rows")
    for w in (4, 16):
        for bb, pp in ((1, 1), (33, 33), (513, 1), (513, 33), (33, 1)):
            st = cron_state(pp, w)
            for i in range(4 if bb > 1 else 8):
                batch, slot = pbatch(bb, pp, i * bb, trap=True,
                                     timer_at=(0,) if bb == 1 and i % 3 == 2 else ())
                st = check_cron(st, batch, slot, now + i, w, pp)[0][0]
    print(f"partition cron kernel: {res[k43]['checks']} K43 checks bit for bit", flush=True)

    # ---- times at the paths' shapes; bytes: each row's lanes and slot list
    # entry read once, each state lane read and written once, each output
    # row's lanes (src, ts, kind, valid; the columns; slot and first row)
    # written once
    col_b = 4 + 4 + 8
    for name, args, rows_out, state_b, fn in (
            (k42, plf_args, plf_rows, p * c_plf * (col_b + 8 + 1 + 8 + 8 + 8) + 8 * p,
             K.partition_lossy_frequent_window_step),
            (k43, pcr_data_args, 0, 2 * p * PCR_W * (col_b + 8) + 8 * p,
             K.partition_cron_window_step)):
        r = res[name]
        r["ms"] = time_ms(torch, lambda: fn(*args), 10)
        r["bound_ms"], r["bound_by"] = (b * (8 + 1 + 1 + 4 + 4 + col_b + (8 if name == k42 else 0))
                                        + 2 * state_b + rows_out * (8 + 1 + 1 + col_b + 4 + 4)) \
            / MEM_BYTES_PER_S * 1e3, "bytes"
        r["rows"] = rows_out
    r = res[k43]
    r["timer_ms"] = time_ms(torch, lambda: K.partition_cron_window_step(*pcr_timer_args), 10)
    r["timer_rows"] = pcr_rows
    r["timer_bound_ms"] = (2 * (2 * p * PCR_W * (col_b + 8) + 8 * p)
                           + pcr_rows * (8 + 1 + 1 + col_b + 4 + 4)) / MEM_BYTES_PER_S * 1e3
    for name in PSP_KERNEL_NAMES:
        r = res[name]
        print(f"kernel {name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) library_ms=None "
              f"checks={r['checks']} exact", flush=True)
    r = res[k43]
    print(f"kernel {k43} TIMER step over {p} slots: ms={r['timer_ms']:.4f} "
          f"plain_ms={r['timer_plain_ms']:.4f} bound_ms={r['timer_bound_ms']:.6f} "
          f"rows={r['timer_rows']}", flush=True)
    return res


AGG_KERNEL_NAMES = ("agg_step", "agg_find_merge")
AGG_DURATIONS = (1000, 60_000, 3_600_000, 86_400_000, -2, -1)  # sec ... year
AGG_GROUPS = 1024
# path AGG's bases: avg(price) -> sum and count, sum(volume), count(),
# min(price), max(price), and the group column kept as last
AGG_OPS = {"sum_avgPrice": "sum", "count_": "count", "sum_total": "sum", "min_lo": "min",
           "max_hi": "max", "last__g_symbol": "last"}
AGG_DTYPES = {"sum_avgPrice": "float32", "count_": "int64", "sum_total": "int64",
              "min_lo": "float32", "max_hi": "float32", "last__g_symbol": "int32"}


def _ms_of(*args) -> int:
    import calendar
    import datetime

    return calendar.timegm(datetime.datetime(*args).timetuple()) * 1000


def aggregation_kernel_phase(torch, dev) -> dict:
    """The incremental aggregation's duration-chain step (K44) and the
    in-flight merge of a find (K45) against their plain versions on the
    card, bit for bit on every store and spill lane, the spill counts and
    the flag: K44 at path AGG's shape (B=32768, G=1024, sec ... year,
    AGG's bases: float32 sums, int64 sums and counts, float32 min/max, an
    int32 last; 1,000 symbols, 32 events a millisecond) over three carried
    batches, then ragged B 1/33/513 with G 4 (the store overflows) and
    1,024, batches crossing a month end, a leap day and a year end, one
    spanning more than four seconds (a fifth close rolls up but is not
    spilled), NaN prices and TIMER rows, and 8,192 groups (K44's key
    indexes past shared memory); K45 for every `per` on each state
    reached; then each kernel's time beside its plain version's and its
    byte bound (no single library call computes either)."""
    from siddhi_tpu_torch.ops import aggregation as A

    res = {k: {"max_abs_err": 0.0, "checks": 0, "library_ms": None} for k in AGG_KERNEL_NAMES}
    rng = np.random.default_rng(1044)
    dts = {"float32": torch.float32, "int64": torch.int64, "int32": torch.int32}

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def fresh(g):
        d = len(AGG_DURATIONS)
        vals = {}
        for bname, op in AGG_OPS.items():
            dt = dts[AGG_DTYPES[bname]]
            vals[bname] = torch.full((d, g), A.base_init(op, dt), dtype=dt, device=dev)
        return {"keys": torch.zeros((d, g), dtype=torch.int64, device=dev),
                "used": torch.zeros((d, g), dtype=torch.bool, device=dev), "vals": vals,
                "bucket": torch.full((d,), -1, dtype=torch.int64, device=dev)}

    def rows(b, t0, per_ms=32, symbols=PT_SYMBOLS, nan=0.0, timers=0.0, span=None):
        ts = (t0 + np.arange(b, dtype=np.int64) // per_ms) if span is None else \
            t0 + np.sort(rng.integers(0, span, b)).astype(np.int64)
        sym = rng.integers(1, symbols + 1, b).astype(np.int32)
        price = arith_traps(rng, rng.uniform(0, 100, b).astype(np.float32), 0.05)
        price[rng.random(b) < nan] = np.nan
        timer = rng.random(b) < timers
        live = ~timer & (rng.random(b) < 0.97)
        con = {"sum_avgPrice": t(price), "count_": t(np.ones(b, np.int64)),
               "sum_total": t(rng.integers(1, 1000, b).astype(np.int64)), "min_lo": t(price),
               "max_hi": t(price), "last__g_symbol": t(sym)}
        return t(ts), t(live), t(timer), t(sym.astype(np.int64)), con

    def check(st, args):
        got = A.agg_step(st, *args, AGG_OPS, list(AGG_DURATIONS))
        want = A.agg_step_ref(st, *args, AGG_OPS, list(AGG_DURATIONS))
        torch.cuda.synchronize()
        same_bits(torch, got, want)
        res["agg_step"]["checks"] += 1
        new = want[0]
        for n in range(1, len(AGG_DURATIONS) + 1):
            fa = (new, n, AGG_DURATIONS[n - 1], AGG_OPS)
            got = A.agg_find_merge(*fa)
            want_f = A.agg_find_merge_ref(*fa)
            torch.cuda.synchronize()
            same_bits(torch, got, want_f)
            res["agg_find_merge"]["checks"] += 1
        return new, want[1]

    b, g = MAIN_BATCH, AGG_GROUPS
    st = fresh(g)
    t0 = 1_700_000_000_000
    for i in range(3):  # path AGG's shape: 1.024 s of event time a batch
        agg_args = rows(b, t0 + i * (b // 32))
        agg_state = st
        st, _o = check(st, agg_args)
    agg_closed = st["spill_n"].tolist()
    edges = (_ms_of(2024, 1, 31, 23, 59, 59), _ms_of(2024, 2, 28, 23, 59, 59),
             _ms_of(2024, 2, 29, 23, 59, 59), _ms_of(2024, 12, 31, 23, 59, 59))
    flagged = False
    for gg in (4, 1024):
        for bb in (1, 33, 513):
            st = fresh(gg)
            for e0 in edges:  # each batch 3 s across the edge
                args = rows(bb, e0, symbols=8 if gg == 4 else 1500, nan=0.05, timers=0.05,
                            span=3000)
                st, ovf = check(st, args)
                flagged = flagged or bool(ovf)
            # a batch spanning ten seconds: a fifth close of the finest
            st, ovf = check(st, rows(max(bb, 33), edges[-1] + 5000, span=10_000, nan=0.05))
            if int(st["spill_n"][0]) <= 4 or not bool(ovf):
                raise AssertionError("K44: a ten-second batch did not spill past four")
    # 8,192 groups: K44's key indexes do not fit in shared memory (lookups
    # scan the store), K45's does
    st = fresh(8192)
    for e0 in edges[:2]:
        st, _o = check(st, rows(4097, e0, symbols=6000, span=3000))
    if not flagged:
        raise AssertionError("K44: no store overflowed G=4")
    print(f"aggregation kernels: {res['agg_step']['checks']} K44 and "
          f"{res['agg_find_merge']['checks']} K45 checks bit for bit", flush=True)

    # ---- times at path AGG's shape; bytes: each row's lanes read once, the
    # stores read and written once, the spills written once (K44); the
    # finest .. year stores read once and the merged store written (K45)
    def nbytes(x):
        return sum(v.numel() * v.element_size() for v in flat(x))

    store_b = nbytes([agg_state["keys"], agg_state["used"], agg_state["vals"],
                      agg_state["bucket"]])
    stepped = A.agg_step(agg_state, *agg_args, AGG_OPS, list(AGG_DURATIONS))[0]
    spill_b = nbytes([stepped["spill"], stepped["spill_n"]])
    r = res["agg_step"]
    r["ms"] = time_ms(torch, lambda: A.agg_step(agg_state, *agg_args, AGG_OPS,
                                                list(AGG_DURATIONS)), 5)
    r["plain_ms"] = time_once(torch, lambda: A.agg_step_ref(agg_state, *agg_args, AGG_OPS,
                                                            list(AGG_DURATIONS)))
    r["us_per_row"] = r["ms"] * 1e3 / b
    r["closes"] = agg_closed
    r["bound_ms"], r["bound_by"] = (nbytes(agg_args) + 2 * store_b + spill_b) \
        / MEM_BYTES_PER_S * 1e3, "bytes"
    r = res["agg_find_merge"]
    n = len(AGG_DURATIONS)
    fa = (stepped, n, AGG_DURATIONS[-1], AGG_OPS)
    r["ms"] = time_ms(torch, lambda: A.agg_find_merge(*fa), 20)
    r["plain_ms"] = time_once(torch, lambda: A.agg_find_merge_ref(*fa))
    r["bound_ms"], r["bound_by"] = (store_b + store_b // n) / MEM_BYTES_PER_S * 1e3, "bytes"
    r["per_ms"] = {str(d): time_ms(torch, lambda _k=k: A.agg_find_merge(
        stepped, _k, AGG_DURATIONS[_k - 1], AGG_OPS), 20)
        for k, d in enumerate(AGG_DURATIONS, start=1)}
    for name in AGG_KERNEL_NAMES:
        r = res[name]
        print(f"kernel {name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) library_ms=None "
              f"checks={r['checks']} exact", flush=True)
    print(f"kernel agg_step: {res['agg_step']['us_per_row']:.3f} us a row at B={b}, G={g}",
          flush=True)
    return res


# ---------------------------------------------------------------------------
# the lossyFrequent and cron windows inside a partition at full width
# ---------------------------------------------------------------------------

PSP_APPS = {
    # per-instrument recurring lot sizes
    "PLF": _PJ_HEAD + """define stream StockStream (symbol string, price float, volume long);
partition with (symbol of StockStream) begin
@info(name='q') from StockStream#window.lossyFrequent(0.1, 0.01, volume)
select symbol, volume insert all events into Out;
end;""",
    # one volume report per instrument per second
    "PCR": "@app:playback\n" + _PJ_HEAD + """define stream StockStream (symbol string, price float,
volume long);
partition with (symbol of StockStream) begin
@info(name='q') from StockStream#window.cron('*/1 * * * * ?')
select symbol, sum(volume) as v group by symbol insert into Out;
end;""",
}
PSP_PATH_KERNELS = {
    "PLF": {"assign_slots": 1, "partition_rows": 1, "partition_lossy_frequent_window_step": 1,
            "pattern_place": 1},
    "PCR": {"assign_slots": 1, "partition_rows": 1, "partition_cron_window_step": 1,
            "pattern_place": 1},
}
PLF_EVENTS, PCR_CALLS = 131_072, 16


def partition_special_path_phase(torch) -> dict:
    """The lossyFrequent and cron windows inside a partition at full width:
    @app:batch 32768, @app:partitionCapacity 1024, 1,000 symbols drawn
    uniformly (seed-7 stock data, 1 ms ticks; PSP_APPS).

    PLF: lossyFrequent(0.1, 0.01, volume) per symbol, `insert all events`,
    PLF_EVENTS events in calls of 4 batches (the first of 1), per batch;
    each kernel's launches held to its uses a step; events/s; the first
    batch against device="cpu"; the busy share of one more call.

    PCR: cron('*/1 * * * * ?') with sum(volume) group by symbol per symbol
    under @app:playback, PCR_CALLS calls of one one-second bucket (1,000
    events) each, every call's clock advance firing the TIMER step that
    reaches every slot; K43 launches = data steps + TIMER steps; the other
    kernels one a step; no overflow; the first two calls against
    device="cpu"."""
    from siddhi_tpu_torch import kernels

    b = MAIN_BATCH
    out = {}
    data, names = pp_data(PLF_EVENTS + 4 * b)
    app = PSP_APPS["PLF"].format(batch=b, cap=PT_CAP)
    wanted = PSP_PATH_KERNELS["PLF"]
    run_app("cuda", app, data, b, b, b, fused=False, symbols=names)  # warm-up
    kernels.launches.clear()
    (n_rows, kept, dt, _i), warned = capture_warnings(
        lambda: run_app("cuda", app, data, PLF_EVENTS, 4 * b, b, fused=False, symbols=names),
        "window")
    launches = dict(kernels.launches)
    steps = PLF_EVENTS // b
    print(f"path PLF launches {json.dumps(launches)} over {steps} steps", flush=True)
    if warned:
        raise AssertionError("path PLF: a window overflowed")
    held_launches("PLF", launches, wanted, steps)
    t0 = time.perf_counter()
    _n, cpu_kept, _dt, _i = run_app("cpu", app, data, b, b, b, fused=False, symbols=names)
    cpu_s = time.perf_counter() - t0
    check_path("PLF", launches, wanted, kept, cpu_kept, 1)
    wall_ms, busy_ms = calls_busy(torch, app, data, 4 * b, 1, 1, ("symbol", "price", "volume"),
                                  names)
    out["PLF"] = {"events": PLF_EVENTS, "rows": n_rows, "seconds": dt,
                  "events_per_s": PLF_EVENTS / dt, "steps": steps, "launches": launches,
                  "cpu_first_batch_rows": len(cpu_kept[0]), "cpu_plain_s": cpu_s,
                  "busy_call_wall_ms": wall_ms, "busy_call_busy_ms": busy_ms,
                  "busy_share": busy_ms / wall_ms}
    print(f"path PLF: {PLF_EVENTS} events, {n_rows} rows delivered, {dt:.3f} s, "
          f"{PLF_EVENTS / dt:.1f} events/s; one call of 4 batches: wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.4f}); the first batch's "
          f"{len(cpu_kept[0])} rows match device='cpu'", flush=True)

    n = PCR_CALLS * CR_BUCKET
    data, names = pp_data(n)
    app = PSP_APPS["PCR"].format(batch=b, cap=PT_CAP)
    wanted = PSP_PATH_KERNELS["PCR"]
    run_app("cuda", app, data, 2 * CR_BUCKET, CR_BUCKET, CR_BUCKET, fused=False,
            symbols=names)  # warm-up
    fires = [0]
    kernels.launches.clear()
    (n_rows, kept, dt, _i), warned = capture_warnings(
        lambda: run_app("cuda", app, data, n, CR_BUCKET, CR_BUCKET, fused=False, fires=fires,
                        keep_calls=2, symbols=names), "window")
    launches = dict(kernels.launches)
    print(f"path PCR launches {json.dumps(launches)} over {PCR_CALLS} data steps and "
          f"{fires[0]} TIMER steps", flush=True)
    if warned:
        raise AssertionError("path PCR: a cron bucket overflowed")
    steps = PCR_CALLS + fires[0]
    if fires[0] < PCR_CALLS - 1:
        raise AssertionError(f"path PCR: {fires[0]} TIMER steps for {PCR_CALLS} buckets")
    held_launches("PCR", launches, wanted, steps)
    t0 = time.perf_counter()
    _n, cpu_kept, _dt, _i = run_app("cpu", app, data, 2 * CR_BUCKET, CR_BUCKET, CR_BUCKET,
                                    fused=False, keep_calls=2, symbols=names)
    cpu_s = time.perf_counter() - t0
    check_path("PCR", launches, wanted, kept, cpu_kept, 2)
    out["PCR"] = {"events": n, "rows": n_rows, "seconds": dt, "events_per_s": n / dt,
                  "data_steps": PCR_CALLS, "timer_steps": fires[0], "launches": launches,
                  "cpu_first_calls_rows": sum(len(c) for c in cpu_kept), "cpu_plain_s": cpu_s}
    print(f"path PCR: {n} events in {PCR_CALLS} one-second calls and {fires[0]} TIMER steps "
          f"over {PT_CAP} slots, {n_rows} rows delivered, {dt:.3f} s, {n / dt:.1f} events/s; "
          f"the first two calls' {sum(len(c) for c in cpu_kept)} rows match device='cpu'",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# the incremental aggregation at full width (paths AGG and AGJ)
# ---------------------------------------------------------------------------

AGG_APP = """@app:batch(size='{batch}') @app:aggGroupCapacity(size='{groups}')
@app:joinCapacity(size='8192')
define stream S (symbol string, price float, volume long, ts long);
define aggregation TradeAgg from S
select symbol, avg(price) as avgPrice, sum(volume) as total, count() as n, min(price) as lo,
max(price) as hi
group by symbol
aggregate by ts every sec ... year;
define stream Probe (symbol string);
@info(name='q') from Probe join TradeAgg on Probe.symbol == TradeAgg.symbol
within {lo}L, {hi}L per 'sec'
select Probe.symbol as s, TradeAgg.AGG_TIMESTAMP as t, TradeAgg.total as total,
TradeAgg.avgPrice as ap, TradeAgg.n as n
insert into Out;"""
AGG_BATCHES, AGJ_CALLS, AGJ_PROBES = 4, 8, 1024
AGG_PER_MS = 32  # the ts lane advances 1 ms every 32 events: 1.024 s a batch
AGG_T0 = 1_700_000_000_000
AGG_HOUR = AGG_T0 - AGG_T0 % 3_600_000  # the within range: the hour holding the feed
AGG_QUERIES = ("from TradeAgg per 'sec' select AGG_TIMESTAMP, symbol, total, n",
               "from TradeAgg within {lo}L, {hi}L per 'min' select symbol, avgPrice, total, lo, "
               "hi")


def agg_app(batch: int = MAIN_BATCH, groups: int = AGG_GROUPS) -> str:
    return AGG_APP.format(batch=batch, groups=groups, lo=AGG_HOUR, hi=AGG_HOUR + 3_600_000)


def agg_data(n: int, per_ms: int = AGG_PER_MS) -> tuple:
    """pp_data's 1,000 symbols with the aggregation's `ts` lane: AGG_T0 +
    one millisecond every `per_ms` events."""
    data, names = pp_data(n)
    data["agg_ts"] = AGG_T0 + np.arange(n, dtype=np.int64) // per_ms
    return data, names


def run_agg(dev, app: str, data: dict, probes: np.ndarray, b: int, batches: int,
            probe_calls: int, names, queries=AGG_QUERIES) -> dict:
    """Drive the AGG app: `batches` calls of one batch of `b` events to S
    (send_columns), then each store query of `queries` once, then
    `probe_calls` calls of AGJ_PROBES probes to Probe. Returns the seconds
    of each part, the query rows, each probe call's joined rows, and the
    aggregation's state and duration tables as numpy."""
    import torch

    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.interop import state_to_numpy

    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(app)
    for s in names:
        mgr.interner.intern(s)
    calls: list = []
    rt.add_callback("q", lambda t, ins, rem: calls[-1].extend(tuple(e.data) for e in ins or []))
    rt.start()
    hs, hp = rt.get_input_handler("S"), rt.get_input_handler("Probe")

    def sync():
        if dev != "cpu":
            torch.cuda.synchronize()

    sync()
    t0 = time.perf_counter()
    for c in range(batches):
        lo, hi = c * b, (c + 1) * b
        hs.send_columns(data["ts"][lo:hi], {"symbol": data["symbol"][lo:hi],
                                            "price": data["price"][lo:hi],
                                            "volume": data["volume"][lo:hi],
                                            "ts": data["agg_ts"][lo:hi]}, now=0)
    sync()
    ingest_s = time.perf_counter() - t0
    agg = rt.aggregations["TradeAgg"]
    state = state_to_numpy(agg.state)
    tables = {t.table_id: state_to_numpy(t.state) for t in agg.tables.values()}
    q_rows, q_s = [], []
    for q in queries:
        q = q.format(lo=AGG_HOUR, hi=AGG_HOUR + 3_600_000)
        t1 = time.perf_counter()
        q_rows.append([tuple(e.data) for e in rt.query(q)])
        q_s.append(time.perf_counter() - t1)
    pts = data["ts"][batches * b - 1] + 1 + np.arange(probe_calls * AGJ_PROBES, dtype=np.int64)
    sync()
    t2 = time.perf_counter()
    for c in range(probe_calls):
        calls.append([])
        lo, hi = c * AGJ_PROBES, (c + 1) * AGJ_PROBES
        hp.send_columns(pts[lo:hi], {"symbol": probes[lo:hi]}, now=0)
    sync()
    probe_s = time.perf_counter() - t2
    rt.shutdown()
    mgr.shutdown()
    return {"ingest_s": ingest_s, "query_rows": q_rows, "query_s": q_s, "calls": calls,
            "probe_s": probe_s, "state": state, "tables": tables}


def aggregation_path_phase(torch) -> dict:
    """Paths AGG and AGJ: the reference's TradeAggregation shape for 1,000
    instruments (agg_app: avg, sum, count, min and max of price and volume
    group by symbol, aggregate by ts every sec ... year, @app:batch 32768,
    @app:aggGroupCapacity 1024; the ts lane 1 ms every 32 events, so 1.024
    s of event time a batch). AGG: AGG_BATCHES batches through send_columns
    (the aggregation's stream runs per batch), K44 launches = the steps;
    events/s; then the store queries AGG_QUERIES (a `per 'sec'` read of
    every closed and in-flight second, a `within .. per 'min'` read), each
    timed, one K45 launch each. AGJ: AGJ_CALLS calls of AGJ_PROBES probes
    (seed-9 symbols) joining `TradeAgg within .. per 'sec'` on symbol, a
    find (K45) and a probe compaction (K12) a step; rows and events/s.
    Against device="cpu": the first batch's stores, duration tables and
    store-query rows, and the first probe call's rows."""
    from siddhi_tpu_torch import kernels

    b = MAIN_BATCH
    data, names = agg_data(AGG_BATCHES * b)
    probes = np.random.default_rng(9).integers(1, PT_SYMBOLS + 1,
                                               AGJ_CALLS * AGJ_PROBES).astype(np.int32)
    app = agg_app()
    run_agg("cuda", app, data, probes, b, 1, 1, names)  # warm-up
    kernels.launches.clear()
    run = run_agg("cuda", app, data, probes, b, AGG_BATCHES, 0, names, queries=())
    ingest = dict(kernels.launches)
    if ingest.get("agg_step", 0) != AGG_BATCHES:
        raise AssertionError(f"path AGG: {ingest.get('agg_step', 0)} K44 launches for "
                             f"{AGG_BATCHES} steps")
    n_ev = AGG_BATCHES * b
    closed = {k: int(v["valid"].sum()) for k, v in run["tables"].items()}
    print(f"path AGG: {n_ev} events in {AGG_BATCHES} steps, {run['ingest_s']:.3f} s, "
          f"{n_ev / run['ingest_s']:.1f} events/s; launches {json.dumps(ingest)}; closed rows "
          f"{json.dumps(closed)}; open groups {run['state']['used'].sum(1).tolist()}",
          flush=True)
    kernels.launches.clear()
    full = run_agg("cuda", app, data, probes, b, AGG_BATCHES, AGJ_CALLS, names)
    launches = dict(kernels.launches)
    finds = launches.get("agg_find_merge", 0)
    if finds != len(AGG_QUERIES) + AGJ_CALLS or launches.get("join_assemble", 0) != AGJ_CALLS:
        raise AssertionError(f"paths AGG/AGJ: {finds} K45 and {launches.get('join_assemble', 0)}"
                             f" K12 launches for {len(AGG_QUERIES)} queries and {AGJ_CALLS} "
                             "probe steps")
    joined = sum(len(c) for c in full["calls"])
    n_probe = AGJ_CALLS * AGJ_PROBES
    if joined < n_probe:
        raise AssertionError(f"path AGJ: {joined} rows for {n_probe} probes")
    # the first batch and the first probe call against device="cpu"
    one = {d: run_agg(d, app, data, probes, b, 1, 1, names) for d in ("cuda", "cpu")}
    for part in ("state", "tables"):
        same_tree_np(one["cuda"][part], one["cpu"][part], f"path AGG {part}")
    for q, got, want in zip(AGG_QUERIES, one["cuda"]["query_rows"], one["cpu"]["query_rows"]):
        if not want or not rows_match(got, want):
            raise AssertionError(f"path AGG: `{q}` differs from device='cpu'")
    if not one["cpu"]["calls"][0] or not rows_match(one["cuda"]["calls"][0],
                                                     one["cpu"]["calls"][0]):
        raise AssertionError("path AGJ: the first probe call differs from device='cpu'")
    out = {"AGG": {"events": n_ev, "steps": AGG_BATCHES, "seconds": run["ingest_s"],
                   "events_per_s": n_ev / run["ingest_s"], "launches": ingest,
                   "closed_rows": closed, "store_query_ms": [x * 1e3 for x in full["query_s"]],
                   "store_query_rows": [len(r) for r in full["query_rows"]]},
           "AGJ": {"probes": n_probe, "calls": AGJ_CALLS, "rows": joined,
                   "seconds": full["probe_s"], "events_per_s": n_probe / full["probe_s"],
                   "launches": launches, "k45_per_step": 1, "k12_per_step": 1,
                   "cpu_first_call_rows": len(one["cpu"]["calls"][0])}}
    print(f"path AGG store queries: {[len(r) for r in full['query_rows']]} rows in "
          f"{[round(x * 1e3, 3) for x in full['query_s']]} ms; path AGJ: {n_probe} probes in "
          f"{AGJ_CALLS} calls, {joined} rows, {full['probe_s']:.3f} s, "
          f"{n_probe / full['probe_s']:.1f} events/s, one K45 and one K12 a step; the first "
          "batch's stores, tables and queries and the first probe call match device='cpu'",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# named windows, triggers and order-by (K46) / composite keys (K47)
# ---------------------------------------------------------------------------

NW_KERNEL_NAMES = ("order_limit", "order_limit_partitioned", "mix_keys")
# path NW: a trigger's leaderboard over a shared window of the last trades,
# with @app:batch(1024) (one batch a send), a group table of 4,096 (1,000
# symbols x 4 venues), ties of v broken by venue (both packages refuse an
# order-by on a string: siddhi_tpu/core/selector.py:153), and a per-venue
# top 3 inside a partition (K46's partition entry on the path)
NW_APP = """@app:playback @app:batch(size='{batch}') @app:joinCapacity(size='{w}')
@app:groupCapacity(size='{groups}')
define stream Trades (symbol string, venue int, price float, volume long);
define window Recent (symbol string, venue int, price float, volume long) length({w}) output all events;
define trigger Tick at every 1 sec;
from Trades insert into Recent;
@info(name='avg') from Recent select symbol, venue, avg(price) as ap group by symbol, venue
insert into VenueAvg;
@info(name='board') from Tick unidirectional join Recent
select Recent.symbol as symbol, Recent.venue as venue, sum(Recent.volume) as v
group by Recent.symbol, Recent.venue order by v desc, venue limit 10 insert into Board;
partition with (venue of Trades) begin
@info(name='top') from Trades select symbol, venue, price order by price desc limit 3
insert into VenueTop;
end;"""
NW_QUERY = "from Recent on volume > 990 select symbol, venue, price order by price desc limit 5"
NW_W, NW_SEND, NW_GROUPS, NW_VENUES = 32768, 1024, 4096, 4
NW_FILL = NW_W // NW_SEND  # calls until the window is full
NW_CALLS, NW_CPU_CALLS, NW_BUSY_CALLS = 16, 4, 8
NW_PARTITIONS = 32  # the default @app:partitionCapacity


def nw_app(w: int = 0, batch: int = 0, groups: int = NW_GROUPS) -> str:
    return NW_APP.format(w=w or NW_W, batch=batch or NW_SEND, groups=groups)


def nw_data(n: int) -> tuple:
    """pp_data's 1,000 symbols with a venue in 1..4 drawn after them from the
    same seed; 1 ms ticks from event time 1, so `at every 1 sec` fires about
    once a 1,024-event call."""
    data, names = pp_data(n)
    rng = np.random.default_rng(7)
    rng.integers(1, PT_SYMBOLS + 1, size=n)  # the symbols' draw
    data["venue"] = rng.integers(1, NW_VENUES + 1, size=n).astype(np.int32)
    data["ts"] = 1 + np.arange(n, dtype=np.int64)
    return data, names


def run_nw(dev, app: str, data: dict, names, calls: int, size: int = 0,
           query: str = NW_QUERY, time_ticks: bool = False, profile_calls: int = 0) -> dict:
    """Drive the NW app: `calls` send_columns calls of `size` trades, the
    store query after each. Returns every callback's rows a call (Board,
    VenueAvg, VenueTop, the Tick fires), the store query's rows a call, the
    seconds of the last `calls - NW_FILL` calls (the window full), the ms of
    each trigger step then (synchronized around the Tick junction's
    publish) and, over the last `profile_calls` calls, (wall ms, device
    busy ms) from torch.profiler."""
    import torch

    from siddhi_tpu_torch import SiddhiManager

    size = size or NW_SEND
    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(app)
    for s in names:
        mgr.interner.intern(s)
    cur = {k: [] for k in ("board", "avg", "top", "ticks")}
    for q in ("board", "avg", "top"):
        rt.add_callback(q, lambda t, ins, rem, _q=q: cur[_q].extend(
            tuple(e.data) for e in ins or []))
    rt.add_callback("Tick", lambda evs: cur["ticks"].extend(e.data[0] for e in evs))
    rt.start()
    h = rt.get_input_handler("Trades")
    tick_ms: list = []
    tj = rt.junctions["Tick"]
    inner = tj.publish_batch
    measuring = False  # the window full: time the trigger steps

    def timed(batch, now):
        if not (time_ticks and measuring):
            inner(batch, now)
            return
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner(batch, now)
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)

    tj.publish_batch = timed
    out = {k: [] for k in (*cur, "query")}
    seconds = 0.0
    busy = None
    for c in range(calls):
        for v in cur.values():
            v.clear()
        measuring = c >= NW_FILL
        lo, hi = c * size, (c + 1) * size
        cols = {k: data[k][lo:hi] for k in ("symbol", "venue", "price", "volume")}

        def one():
            h.send_columns(data["ts"][lo:hi], cols, now=0)
            return [tuple(e.data) for e in rt.query(query)]

        if dev != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if profile_calls and c == calls - profile_calls:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])  # the device alone: less overhead
            prof.__enter__()
            p0 = t0
        rows = one()
        if dev != "cpu":
            torch.cuda.synchronize()
        if measuring:
            seconds += time.perf_counter() - t0
        for k, v in cur.items():
            out[k].append(list(v))
        out["query"].append(rows)
    if profile_calls:
        wall = (time.perf_counter() - p0) * 1e3
        prof.__exit__(None, None, None)
        busy_us = 0.0
        for e in prof.key_averages():
            dev_us = getattr(e, "self_device_time_total", None)
            busy_us += e.self_cuda_time_total if dev_us is None else dev_us
        busy = (wall, busy_us / 1e3)
    rt.shutdown()
    mgr.shutdown()
    out.update(seconds=seconds, tick_ms=tick_ms, busy=busy)
    return out


SORT_TILE = 2048  # csrc/radix_sort.cuh kSortTile: one block up to it, the grid above
# the entry points of csrc/radix_sort.cuh's sort (K46 flat and partitioned,
# K22's build) and K22's probe
SORT_KERNELS = ("order_limit", "order_limit_partitioned", "table_index_build",
                "table_index_probe")


def _every_byte_key(rng, dtype: str, r: int) -> np.ndarray:
    """A key lane whose sort words vary in every byte: int64 uniform over its
    whole range, or float32 over every bit pattern, with INT64_MIN/MAX, NaN
    of both signs, -0.0, subnormals and +-inf mixed in."""
    if dtype == "int64":
        k = rng.integers(-(2**63), 2**63 - 1, r, endpoint=True).astype(np.int64)
        edges = np.array([-(2**63), 2**63 - 1, 0, -1], np.int64)
    else:
        k = rng.integers(0, 2**32, r, dtype=np.uint64).astype(np.uint32).view(np.float32)
        edges = np.concatenate([
            np.array([np.nan, -0.0, 0.0, 1e-40, -1e-40, np.inf, -np.inf], np.float32),
            np.array([0xFFC00000, 0x7F800001, 0x00000001, 0x80000001], np.uint32).view(np.float32)])
    pick = rng.random(r) < 0.05
    k[pick] = rng.choice(edges, int(pick.sum()))
    return k


def _order_key(rng, dtype: str, r: int) -> np.ndarray:
    """An order key lane with the encoding's edge values and many ties."""
    if dtype == "int32":
        base = rng.integers(-3, 4, r).astype(np.int32)
        edges = np.array([-(2**31), 2**31 - 1, 0, -1, 1], np.int32)
    elif dtype == "int64":
        base = rng.integers(-3, 4, r).astype(np.int64)
        edges = np.array([-(2**63), 2**63 - 1, 0, -1, 2**40], np.int64)
    elif dtype == "float32":
        base = rng.choice(np.array([-1.5, 0.25, 2.0], np.float32), r)
        edges = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-38], np.float32)
        edges = np.concatenate([edges, np.array([0xFFC00000], np.uint32).view(np.float32)])
    else:
        return rng.random(r) < 0.5
    pick = rng.random(r) < 0.4
    base[pick] = rng.choice(edges, int(pick.sum()))
    return base


def named_window_kernel_phase(torch, dev, kernel_sums: bool = False) -> dict:
    """K46 (flat and per partition) and K47 against their plain versions
    on the card, exactly (the permutation, the kept mask, the keys bit for
    bit), the plain versions on CPU copies of the same inputs: K46 at path
    NW's shapes (the leaderboard's 32,768 joined rows by `v desc, venue`
    limit 10, the store query's 32,768 window rows by `price desc` limit 5
    with ~1% valid, the per-venue top 3 of a 1,024-row batch over 32
    partitions) and ragged (R 1/33/32,768, 1-4 keys of int32, int64,
    float32 and bool asc and desc with INT_MIN/MAX, -0.0, subnormals,
    +-inf and NaN of both signs, offset alone, limit alone, no key; P
    1/8/33/1,024 and 10,000 past shared memory), at the radix sort's tile
    edges and above (R 2,047/2,048/2,049/4,097/65,537/10^6, flat and P=33),
    with keys varying in every byte (uniform int64, float32 over every bit
    pattern) and all rows invalid; K47 over 2-8 columns of int32, int64,
    bool and float32 (negative, extreme, NaN, -0.0) at 32,768 rows and
    ragged. Then each kernel's time: ms the whole wrapper call (CUDA
    events), device_ms its kernels alone (`device_all_ms`), beside its plain
    version's and its byte bound; K46's library call is one stable
    torch.sort of the encoded single key, timed alike (library_ms,
    library_device_ms); the every-byte keys timed at the board's 32,768
    rows; K47 has no library call. kernel_sums (`--sorts`): K46's and the
    library call's kernel times summed by torch.profiler as well (kernel_ms,
    library_kernel_ms), which leave out the gaps between kernels."""
    from siddhi_tpu_torch.core import selector as S
    from siddhi_tpu_torch.ops import group as G

    res = {k: {"max_abs_err": 0.0, "checks": 0, "library_ms": None} for k in NW_KERNEL_NAMES}
    rng = np.random.default_rng(1546)
    big = 2**31 - 1

    def both(x):
        c = torch.from_numpy(np.ascontiguousarray(x))
        return c, c.to(dev)

    def check_order(r, dtypes, desc, lo, hi, p=None, valid_p=0.85, keys=None):
        valid = rng.random(r) < valid_p
        keys = [_order_key(rng, d, r) for d in dtypes] if keys is None else keys
        v_c, v_g = both(valid)
        kc, kg = zip(*[both(k) for k in keys]) if keys else ((), ())
        if p is None:
            name = "order_limit"
            want = S.order_limit_ref(v_c, list(kc), desc, lo, hi)
            got = S.order_limit(v_g, list(kg), desc, lo, hi)
        else:
            name = "order_limit_partitioned"
            part = np.where(valid | (rng.random(r) < 0.5), rng.integers(0, p, r), p)
            pc, pg = both(part.astype(np.int64))
            want = S.order_limit_partitioned_ref(v_c, list(kc), desc, pc, p, lo, hi)
            got = S.order_limit_partitioned(v_g, list(kg), desc, pg, p, lo, hi)
        torch.cuda.synchronize()
        if (got[0] is None) != (want[0] is None) or not torch.equal(got[1].cpu(), want[1]) or (
                want[0] is not None and not torch.equal(got[0].cpu().long(), want[0])):
            raise AssertionError(f"K46 {name} differs from its plain version at R={r}, "
                                 f"keys {dtypes}, desc {desc}, [{lo}, {hi}), P={p}")
        res[name]["checks"] += 1
        return v_g, list(kg)

    # path NW's shapes
    board_args = check_order(NW_W, ["int64", "int32"], [True, False], 0, 10, valid_p=1.0, keys=[
        rng.integers(1, 40_000, NW_W).astype(np.int64),
        rng.integers(1, PT_SYMBOLS + 1, NW_W).astype(np.int32)])
    query_args = check_order(NW_W, ["float32"], [True], 0, 5, valid_p=0.01)
    top_args = check_order(NW_SEND, ["float32"], [True], 0, 3, p=NW_PARTITIONS, valid_p=1.0)
    ragged = [(1, ["float32"], [True], 0, 1), (33, ["int32"], [False], 2, big),
              (33, ["float32", "int64"], [True, False], 0, 5),
              (33, ["bool", "float32"], [True, False], 1, 4),
              (33, [], [], 3, 13), (NW_W, ["int64", "int32", "float32"], [True, True, False],
                                    0, big),
              (NW_W, ["float32", "bool", "int32", "int64"], [False, False, True, True], 7, 27),
              (NW_W, [], [], 100, 200)]
    for case in ragged:
        check_order(*case)
        if case[0] > 1:
            for p in (1, 8, 33, 1024):
                check_order(*case, p=p)
    check_order(33, ["int32"], [True], 0, 2, p=10_000)
    check_order(33, [], [], 1, 3, p=10_000)
    check_order(NW_W, ["float32"], [False], 0, big, p=10_000)
    # csrc/radix_sort.cuh: one block up to a tile, the grid above it; keys
    # varying in every byte; a chunk with no valid row
    for r in (SORT_TILE - 1, SORT_TILE, SORT_TILE + 1, 2 * SORT_TILE + 1, 65_537, 1_000_000):
        check_order(r, ["int64", "int32"], [True, False], 0, 10)
        check_order(r, ["float32", "bool"], [False, True], 3, big, p=33)
    every = {}
    for dt in ("int64", "float32"):
        for r in (SORT_TILE + 1, NW_W):
            every[dt] = check_order(r, [dt], [dt == "float32"], 0, big,
                                    keys=[_every_byte_key(rng, dt, r)])
            check_order(r, [dt], [False], 0, 10, p=33, keys=[_every_byte_key(rng, dt, r)])
    for r in (1000, NW_W):
        check_order(r, ["float32"], [True], 0, 5, valid_p=0.0)
        check_order(r, ["float32"], [True], 0, 5, p=33, valid_p=0.0)

    # K47
    def mix_col(dtype, n):
        if dtype == "int32":
            c = rng.integers(-(2**31), 2**31, n).astype(np.int32)
        elif dtype == "int64":
            c = rng.integers(-(2**63), 2**63 - 1, n, endpoint=True).astype(np.int64)
        elif dtype == "float32":
            c = rng.normal(0, 1e3, n).astype(np.float32)
            k = min(n, 4)
            c[:k] = np.array([0.0, -0.0, np.nan, -np.inf], np.float32)[:k]
        else:
            c = rng.random(n) < 0.5
        return c

    kinds = ["int64", "int32", "float32", "bool"]
    for n in (1, 33, NW_W):
        for ncols in range(2, 9):
            cols = [mix_col(kinds[(ncols + i) % 4], n) for i in range(ncols)]
            cc, cg = zip(*[both(c) for c in cols])
            got = G.mix_keys(list(cg))
            want = G.mix_keys_ref(list(cc))
            torch.cuda.synchronize()
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"K47 differs from its plain version: {ncols} columns, {n} rows")
            res["mix_keys"]["checks"] += 1
    # NW's composite keys: (symbol, venue) as the callers' int64 lanes
    mix_args = [torch.from_numpy(rng.integers(1, PT_SYMBOLS + 1, NW_W).astype(np.int64)).to(dev),
                torch.from_numpy(rng.integers(1, NW_VENUES + 1, NW_W).astype(np.int64)).to(dev)]
    print(f"named-window kernels: {res['order_limit']['checks']} flat and "
          f"{res['order_limit_partitioned']['checks']} partitioned K46 checks, "
          f"{res['mix_keys']['checks']} K47 checks, exact", flush=True)

    # ---- times at path NW's shapes
    def nbytes(*xs):
        return sum(x.numel() * x.element_size() for x in xs)

    v_g, kg = board_args
    r = res["order_limit"]

    def board():
        return S.order_limit(v_g, kg, [True, False], 0, 10)

    r["ms"] = time_ms(torch, board, 20)
    r["device_ms"] = device_all_ms(torch, board, 20)
    r["plain_ms"] = time_ms(torch, lambda: S.order_limit_ref(v_g, kg, [True, False], 0, 10), 5)
    # bytes: the keys and the mask read once, the permutation and mask written
    r["bound_ms"], r["bound_by"] = (nbytes(v_g, *kg) + NW_W * 5) / MEM_BYTES_PER_S * 1e3, "bytes"
    enc = (-kg[0]) ^ torch.iinfo(torch.int64).min  # the single int64 key, encoded
    r["library_ms"] = time_ms(torch, lambda: torch.sort(enc, stable=True), 20)
    r["library_device_ms"] = device_all_ms(torch, lambda: torch.sort(enc, stable=True), 20)

    def sums(row, call, lib):
        if kernel_sums:
            row["kernel_ms"] = device_ms(torch, lambda: None, call, 20, None)
            row["library_kernel_ms"] = device_ms(torch, lambda: None, lib, 20, None)

    sums(r, board, lambda: torch.sort(enc, stable=True))
    r["every_byte"] = {}
    for dt, (ev, ek) in every.items():  # one key of every byte, at the board's 32,768 rows
        def call(ev=ev, ek=ek, dt=dt):
            return S.order_limit(ev, ek, [dt == "float32"], 0, big)

        def lib(ek=ek):
            return torch.sort(ek[0], stable=True)

        r["every_byte"][dt] = {
            "ms": time_ms(torch, call, 20), "device_ms": device_all_ms(torch, call, 20),
            "library_ms": time_ms(torch, lib, 20),
            "library_device_ms": device_all_ms(torch, lib, 20),
            "bound_ms": (nbytes(ev, *ek) + NW_W * 5) / MEM_BYTES_PER_S * 1e3}
        sums(r["every_byte"][dt], call, lib)
    qv, qk = query_args
    r["query_ms"] = time_ms(torch, lambda: S.order_limit(qv, qk, [True], 0, 5), 20)
    r["query_plain_ms"] = time_ms(torch, lambda: S.order_limit_ref(qv, qk, [True], 0, 5), 5)
    r = res["order_limit_partitioned"]
    tv, tk = top_args
    tpart = torch.from_numpy(rng.integers(0, NW_VENUES, NW_SEND).astype(np.int64)).to(dev)

    def top():
        return S.order_limit_partitioned(tv, tk, [True], tpart, NW_PARTITIONS, 0, 3)

    r["ms"] = time_ms(torch, top, 20)
    r["device_ms"] = device_all_ms(torch, top, 20)
    r["plain_ms"] = time_ms(torch, lambda: S.order_limit_partitioned_ref(
        tv, tk, [True], tpart, NW_PARTITIONS, 0, 3), 5)
    r["bound_ms"], r["bound_by"] = ((nbytes(tv, *tk, tpart) + NW_SEND * 5) / MEM_BYTES_PER_S
                                    * 1e3, "bytes")
    # (partition, encoded key) as one int64 key
    tenc = (tpart << 32) | (tk[0].view(torch.int32).to(torch.int64) & 0xFFFFFFFF)
    r["library_ms"] = time_ms(torch, lambda: torch.sort(tenc, stable=True), 20)
    r["library_device_ms"] = device_all_ms(torch, lambda: torch.sort(tenc, stable=True), 20)
    sums(r, top, lambda: torch.sort(tenc, stable=True))
    r = res["mix_keys"]
    r["ms"] = time_ms(torch, lambda: G.mix_keys(mix_args), 50)
    r["plain_ms"] = time_ms(torch, lambda: G.mix_keys_ref(mix_args), 20)
    r["bound_ms"], r["bound_by"] = (nbytes(*mix_args) + NW_W * 8) / MEM_BYTES_PER_S * 1e3, "bytes"
    for name in NW_KERNEL_NAMES:
        r = res[name]
        print(f"kernel {name}: ms={r['ms']:.4f} device_ms={r.get('device_ms')} "
              f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) "
              f"library_ms={r['library_ms']} library_device_ms={r.get('library_device_ms')} "
              f"kernel_ms={r.get('kernel_ms')} library_kernel_ms={r.get('library_kernel_ms')} "
              f"checks={r['checks']} exact", flush=True)
    print(f"kernel order_limit, one key varying in every byte, {NW_W} rows: "
          f"{json.dumps(res['order_limit']['every_byte'])}", flush=True)
    print(f"kernel order_limit at the store query's shape: ms={res['order_limit']['query_ms']:.4f}"
          f" plain_ms={res['order_limit']['query_plain_ms']:.4f}", flush=True)
    return res


NW_PATH_KERNELS = ("order_limit", "order_limit_partitioned", "mix_keys", "length_window_step",
                   "ring_view", "join_assemble", "assign_slots", "keyed_running_sum")


def named_window_path_phase(torch) -> dict:
    """Path NW (nw_app): 1,000 symbols x 4 venues of trades into a shared
    length(32,768) window, its emissions grouped by (symbol, venue) into
    VenueAvg; a 1 sec trigger under @app:playback joining the whole window
    (unidirectional), grouped by (symbol, venue), `order by v desc, venue
    limit 10` into Board; a per-venue top 3 inside a partition; a store
    query over the window after each call. Calls of 1,024 events (1 ms
    ticks, so about one trigger step a call); NW_FILL calls fill the
    window, then NW_CALLS calls are timed: events/s, trigger steps a call,
    ms a trigger step (the join of 32,768 rows and what follows), the busy
    share of the last NW_BUSY_CALLS calls. Every delivered row and the
    store query's rows of the first NW_CPU_CALLS calls against
    device="cpu"; the counts read just after the run."""
    from siddhi_tpu_torch import kernels

    calls = NW_FILL + NW_CALLS
    data, names = nw_data(calls * NW_SEND)
    app = nw_app()
    run_nw("cuda", app, data, names, 2)  # warm-up
    kernels.launches.clear()
    run = run_nw("cuda", app, data, names, calls, time_ticks=True)
    launches = dict(kernels.launches)
    fires = sum(len(t) for t in run["ticks"][NW_FILL:])
    for k in NW_PATH_KERNELS:
        if launches.get(k, 0) < 1:
            raise AssertionError(f"path NW: kernel {k} was not launched")
    # K46: a trigger step, the window side's step (each call's window
    # emissions: it probes nothing but runs the selector) and a store query
    all_fires = sum(len(t) for t in run["ticks"])
    if launches["order_limit"] != all_fires + 2 * calls:
        raise AssertionError(f"path NW: {launches['order_limit']} K46 launches for {all_fires} "
                             f"trigger steps, {calls} window steps and {calls} store queries")
    if not fires or any(len(b) != 10 * len(t) for b, t in zip(run["board"][NW_FILL:],
                                                               run["ticks"][NW_FILL:])):
        raise AssertionError("path NW: a trigger step over the full window gave no top 10")
    n_ev = NW_CALLS * NW_SEND
    busy_run = run_nw("cuda", app, data, names, calls, profile_calls=NW_BUSY_CALLS)
    wall, busy = busy_run["busy"]
    cpu = run_nw("cpu", app, data, names, NW_CPU_CALLS)
    gpu = run_nw("cuda", app, data, names, NW_CPU_CALLS)
    for k in ("board", "avg", "top", "ticks", "query"):
        if not any(cpu[k]) or not rows_match(gpu[k], cpu[k]):
            raise AssertionError(f"path NW: the {k} rows differ from device='cpu'")
    tick = run["tick_ms"]
    out = {"events": n_ev, "calls": NW_CALLS, "seconds": run["seconds"],
           "events_per_s": n_ev / run["seconds"], "trigger_steps": fires,
           "trigger_steps_per_call": fires / NW_CALLS,
           "trigger_step_ms": {"mean": float(np.mean(tick)), "min": float(np.min(tick)),
                               "max": float(np.max(tick))},
           "busy": {"calls": NW_BUSY_CALLS, "wall_ms": wall, "busy_ms": busy,
                    "share": busy / wall},
           "launches": launches,
           "rows_per_call": {k: float(np.mean([len(x) for x in run[k][NW_FILL:]]))
                             for k in ("board", "avg", "top", "query")},
           "cpu_calls": NW_CPU_CALLS}
    print(f"path NW: {n_ev} events in {NW_CALLS} calls (window full), {run['seconds']:.3f} s, "
          f"{out['events_per_s']:.1f} events/s; {fires} trigger steps "
          f"({out['trigger_steps_per_call']:.3f} a call), {out['trigger_step_ms']['mean']:.3f} ms "
          f"a trigger step (min {out['trigger_step_ms']['min']:.3f}, max "
          f"{out['trigger_step_ms']['max']:.3f}); busy {busy:.2f} / {wall:.2f} ms "
          f"({busy / wall:.4f}) over {NW_BUSY_CALLS} calls; launches {json.dumps(launches)}; "
          f"rows a call {json.dumps(out['rows_per_call'])}; the first {NW_CPU_CALLS} calls' "
          "rows and store queries match device='cpu'", flush=True)
    return out


# slice 16: event lineage and the flight recorder (@app:lineage, K48)
LIN_CAP, LIN_K = 262_144, 8
# per app two fused calls: 2 batches (held against device="cpu"), then 8
# (262,144 events, one fused K=8 call: timed, and the arena's capacity)
LIN_CALLS = (2 * MAIN_BATCH, LIN_K * MAIN_BATCH)
LIN_SAMPLE_EVERY, LIN_FLIGHT = 16, 1024
LIN_APPS = {
    "Q": MAIN_APP.format(batch=MAIN_BATCH, w=MAIN_W, extra="").replace(
        "define stream", f"@flightRecorder(size='{LIN_FLIGHT}') define stream"),
    "J": JOIN_APP.format(cap=JOIN_CAP, batch=MAIN_BATCH, playback="", win=f"length({JOIN_W})"),
    "P": PATTERN_APP.format(batch=MAIN_BATCH),
}
LIN_PATH_KERNELS = {"Q": ("length_window_step", "running_sum", "wire_decode", "deliver_pack"),
                    "J": ("length_window_step", "ring_view", "ring_view_seq", "join_assemble",
                          "wire_decode", "deliver_pack"),
                    "P": ("pattern_advance", "pattern_emit", "wire_decode", "deliver_pack")}


def lin_app(label: str, lineage: bool = True, sample: bool = False) -> str:
    mode = f", mode='sample', sample.every='{LIN_SAMPLE_EVERY}'" if sample else ""
    head = f"@app:lineage(capacity='{LIN_CAP}'{mode})\n" if lineage else ""
    return head + f"@app:ingestChunk(size='{LIN_K}')\n" + LIN_APPS[label]


def run_lin(dev, app: str, data: dict, sizes, keep_records: bool = False) -> dict:
    """Drive one LIN app through send_columns, one call a size (each at
    least 2 batches: fused), query "q" delivering to a callback. Returns
    the rows (ts, data) in order, each call's seconds (host clock around a
    synchronize), and under lineage the recorder's counters, the first
    call's records, each call's last 16 records resolved, the flight ring
    after each call, and with `keep_records` every kept record at the end
    (records are built as dicts only when read)."""
    import torch

    from siddhi_tpu_torch import SiddhiManager

    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(app)
    for s in SYMBOLS:
        mgr.interner.intern(s)
    rows = []
    rt.add_callback("q", lambda t, ins, rem: rows.extend(
        (e.timestamp, tuple(e.data)) for e in ins or []))
    rt.start()
    j = rt.junctions["StockStream"]
    lin = rt.queries["q"].lineage
    h = rt.get_input_handler("StockStream")
    out: dict = {"calls": []}
    sent = 0
    for i, n in enumerate(sizes):
        if dev != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        h.send_columns(data["ts"][sent:sent + n],
                       {k: data[k][sent:sent + n] for k in ("symbol", "price", "volume")}, now=0)
        if dev != "cpu":
            torch.cuda.synchronize()
        call = {"events": n, "seconds": time.perf_counter() - t0, "rows": len(rows)}
        sent += n
        if lin is not None:
            if i == 0:
                out["first_records"] = lin.records
            call["chains"] = [rt.lineage("q", r["out_index"]) for r in lin.recent(16)]
        if j.flight is not None:
            call["flight"] = rt.flight_record("StockStream")
        out["calls"].append(call)
    out["rows"] = rows
    out["chunks"] = j.fused_ingest.chunks_dispatched
    if lin is not None:
        out["lin"] = {"out_count": lin.out_count, "pub_count": lin.pub_count,
                      "in_seen": lin.in_seen, "desync": lin.desync,
                      "recorded": len(lin.records), "approx": lin.approx_count,
                      "arena_next_seq": j.lineage.next_seq}
        if keep_records:
            out["records"] = lin.records
    rt.shutdown()
    mgr.shutdown()
    return out


def lineage_kernel_phase(torch, dev) -> dict:
    """K48, the seq view, against its plain version on the card, exactly:
    path LIN's J ring (a full length(100) ring after 3 batches of 32,768),
    a time(1 sec) ring of 1,024 slots with holes (ragged batches, then a
    gap that leaves part of it live), length rings of W 1, 50 and 1,024 and
    an empty ring; `ring_view(..., with_seq=True)` against the plain view
    and seqs, the lanes paired. Times at the J ring; the library figure is
    one stable torch.argsort of the seq lane and one gather."""
    from siddhi_tpu_torch.core.event import EventBatch, StreamSchema
    from siddhi_tpu_torch.core.types import AttrType
    from siddhi_tpu_torch.core.windows import (
        SlidingWindow,
        length_window_step_ref,
        ring_view,
        ring_view_ref,
        ring_view_seq,
        ring_view_seq_ref,
        time_window_step_ref,
    )

    schema = StreamSchema("StockStream", [("symbol", AttrType.STRING), ("price", AttrType.FLOAT),
                                          ("volume", AttrType.LONG)])
    rng = np.random.default_rng(48)

    def batch(b, clock, p_valid=1.0):
        d = stock_data(b, seed=int(rng.integers(1 << 30)))
        ts = clock + np.cumsum(rng.integers(0, 3, b)).astype(np.int64)
        valid = rng.random(b) < p_valid
        return EventBatch(ts=torch.from_numpy(ts).to(dev),
                          kind=torch.zeros(b, dtype=torch.int8, device=dev),
                          valid=torch.from_numpy(valid).to(dev),
                          cols={n: torch.from_numpy(d[n]).to(dev)
                                for n in ("symbol", "price", "volume")})

    def length_ring(w, batches, b):
        st = SlidingWindow(schema, "S", w, dev).init_state()
        for _ in range(batches):
            st = length_window_step_ref(st, batch(b, 0, 0.9), w)[3]
        return st

    t_ring = SlidingWindow(schema, "S", TIME_W, dev, duration_ms=1000).init_state()
    clock = 1_700_000_000_000
    for gap in (0, 0, 1700):
        bt = batch(4097, clock + gap, 0.9)
        t_ring = time_window_step_ref(t_ring, bt, bt.ts, TIME_W, 1000)[3]
        clock = int(bt.ts.max().item())
    rings = {"J": length_ring(JOIN_W, 3, MAIN_BATCH), "time_holes": t_ring,
             "W1": length_ring(1, 2, 33), "W50": length_ring(50, 2, 33),
             "W1024": length_ring(1024, 2, 513),
             "empty": SlidingWindow(schema, "S", 64, dev).init_state()}
    for label, st in rings.items():
        got, want = ring_view_seq(st), ring_view_seq_ref(st)
        paired = ring_view(st, with_seq=True)
        torch.cuda.synchronize()
        same_bits(torch, [got, list(paired)], [want, [*ring_view_ref(st), want]])
        print(f"kernel check ring_view_seq {label} W={st['seq'].shape[0]}: "
              f"{int((want >= 0).sum().item())} live slots ok", flush=True)
    st = rings["J"]
    seq = st["seq"]
    w = seq.shape[0]
    r = {"max_abs_err": 0.0,
         "ms": time_ms(torch, lambda: ring_view_seq(st), 200),
         "plain_ms": time_ms(torch, lambda: ring_view_seq_ref(st), 200),
         "library_ms": time_ms(torch, lambda: seq[torch.argsort(seq, stable=True)], 200),
         # the seq lane and total read once, the view's seqs written once
         "bound_ms": (8 * w + 8 + 8 * w) / MEM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "W1024_ms": time_ms(torch, lambda: ring_view_seq(rings["time_holes"]), 200)}
    print(f"kernel ring_view_seq: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
          f"bound_ms={r['bound_ms']:.6f} (bytes) library_ms={r['library_ms']:.4f} "
          f"max_abs_err=0.0; at W=1024: {r['W1024_ms']:.4f} ms", flush=True)
    return {"ring_view_seq": r}


def arena_d2h_ms(torch) -> dict:
    """The arena's per-batch publish: `LineageArena.record_batch` of a
    32,768-row batch on the card (one device-to-host copy of its packed
    lanes, then the ring write), host clock around it, 20 reps after one
    warm-up."""
    from siddhi_tpu_torch.core.event import EventBatch, StreamSchema
    from siddhi_tpu_torch.core.types import AttrType, InternTable
    from siddhi_tpu_torch.observability.lineage import LineageArena

    schema = StreamSchema("StockStream", [("symbol", AttrType.STRING), ("price", AttrType.FLOAT),
                                          ("volume", AttrType.LONG)])
    d = stock_data(MAIN_BATCH, seed=16)
    b = EventBatch(ts=torch.from_numpy(d["ts"]).cuda(),
                   kind=torch.zeros(MAIN_BATCH, dtype=torch.int8, device="cuda"),
                   valid=torch.ones(MAIN_BATCH, dtype=torch.bool, device="cuda"),
                   cols={n: torch.from_numpy(d[n]).cuda() for n in ("symbol", "price", "volume")})
    arena = LineageArena(schema, InternTable(), LIN_CAP)
    arena.record_batch(b)
    torch.cuda.synchronize()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        arena.record_batch(b)
    ms = (time.perf_counter() - t0) / reps * 1e3
    lane_bytes = MAIN_BATCH * (8 + 1 + 1 + 4 + 4 + 8)
    if arena.next_seq != (reps + 1) * MAIN_BATCH:
        raise AssertionError("arena: a publish was not stamped")
    return {"rows": MAIN_BATCH, "bytes": lane_bytes, "ms": ms,
            "GB_per_s": lane_bytes / ms / 1e6}


def lineage_path_phase(torch) -> dict:
    """Path LIN: the quickstart (BASELINE.json config 1, its stream with
    @flightRecorder(size='1024')), J (sliding_join's length(100) self-join)
    and P (pattern_2state), each at @app:batch 32,768 with
    @app:lineage(capacity='262144') and @app:ingestChunk 8, in two fused
    calls: 2 batches, then 8 (262,144 events, the arena's capacity). Each
    app with lineage on (launch counts from 0 just before, read just after)
    and off, J also in sample mode (every 16th output recorded). Checks:
    the rows on equal to off, byte for byte; the recorder saw every event
    (its input count, the arena's seqs), never desynchronized and counted
    every delivered row as published; the first call's records and its last
    16 outputs resolved equal to the same call on device="cpu"; every input
    event of the last call's last 16 outputs decoded; K48 launched once a
    join probe step (two a micro-batch for the self-join); the sample
    records the full records' every 16th; the flight ring equal to the
    CPU's after the first call and to the last 1,024 events after the
    second. Events/s of the second call, on and off; and the arena's
    per-batch D2H."""
    from siddhi_tpu_torch import kernels

    n_all = sum(LIN_CALLS)
    data = stock_data(n_all, seed=7)
    out: dict = {}
    for label in ("Q", "J", "P"):
        run_lin("cuda", lin_app(label), data, (2 * MAIN_BATCH,))  # warm-up, not counted
        kernels.launches.clear()
        on = run_lin("cuda", lin_app(label), data, LIN_CALLS, keep_records=label == "J")
        launches = dict(kernels.launches)
        off = run_lin("cuda", lin_app(label, lineage=False), data, LIN_CALLS)
        cpu = run_lin("cpu", lin_app(label), data, LIN_CALLS[:1])
        for k in LIN_PATH_KERNELS[label]:
            if launches.get(k, 0) <= 0:
                raise AssertionError(f"path LIN {label}: kernel {k} was not launched")
        if launches.get("ring_view_seq", 0) != (2 * n_all // MAIN_BATCH if label == "J" else 0):
            raise AssertionError(f"path LIN {label}: {launches.get('ring_view_seq', 0)} K48 "
                                 "launches, expected one a join probe step")
        if on["rows"] != off["rows"] or not on["rows"]:
            raise AssertionError(f"path LIN {label}: the rows differ with lineage on and off")
        lin = on["lin"]
        seen = lin["in_seen"] if isinstance(lin["in_seen"], int) else set(lin["in_seen"].values())
        if (lin["out_count"] <= 0 or lin["recorded"] <= 0 or lin["desync"]
                or seen not in (n_all, {n_all}) or lin["arena_next_seq"] != n_all
                or lin["pub_count"] != len(on["rows"])):
            raise AssertionError(f"path LIN {label}: the recorder missed events or outputs: "
                                 f"{json.dumps(lin, default=str)}, {len(on['rows'])} rows")
        if on["first_records"] != cpu["first_records"] or not cpu["first_records"]:
            raise AssertionError(f"path LIN {label}: the first call's records differ from "
                                 "device='cpu'")
        if on["calls"][0]["chains"] != cpu["calls"][0]["chains"]:
            raise AssertionError(f"path LIN {label}: the first call's last 16 outputs resolve "
                                 "to other events than on device='cpu'")
        last = on["calls"][-1]["chains"]
        if len(last) != 16 or any(e.get("event") is None for c in last for i in c["inputs"]
                                  for e in i.get("events", ())):
            raise AssertionError(f"path LIN {label}: the last call's outputs did not resolve")
        sec_on, sec_off = on["calls"][-1]["seconds"], off["calls"][-1]["seconds"]
        r = {"events": n_all, "timed_call_events": LIN_CALLS[-1], "rows": len(on["rows"]),
             "chunks": on["chunks"], "launches": launches,
             "records": lin["recorded"], "outputs": lin["out_count"],
             "approx_records": lin["approx"],
             "seconds_on": sec_on, "seconds_off": sec_off,
             "events_per_s_on": LIN_CALLS[-1] / sec_on,
             "events_per_s_off": LIN_CALLS[-1] / sec_off,
             "cpu_compared_events": LIN_CALLS[0]}
        if label == "Q":
            fl = on["calls"]
            if (fl[0]["flight"] != cpu["calls"][0]["flight"]
                    or [t for t, _d in fl[-1]["flight"]]
                    != data["ts"][n_all - LIN_FLIGHT:n_all].tolist()):
                raise AssertionError("path LIN Q: the flight ring differs from device='cpu' "
                                     "or from the last events")
            r["flight_events"] = len(fl[-1]["flight"])
        if label == "J":
            sample = run_lin("cuda", lin_app("J", sample=True), data, LIN_CALLS,
                             keep_records=True)
            every = [x for x in on["records"] if x["out_index"] % LIN_SAMPLE_EVERY == 0]
            if sample["records"] != every or sample["rows"] != off["rows"]:
                raise AssertionError("path LIN J: sample mode did not record every 16th output")
            r["sample"] = {"records": len(sample["records"]),
                           "seconds": sample["calls"][-1]["seconds"],
                           "events_per_s": LIN_CALLS[-1] / sample["calls"][-1]["seconds"]}
        out[label] = r
        print(f"path LIN {label}: {n_all} events ({r['chunks']} fused chunks), {r['rows']} rows, "
              f"{r['outputs']} outputs recorded ({r['records']} kept, {r['approx_records']} "
              f"approx); the {LIN_CALLS[-1]}-event call {sec_on:.3f} s with lineage "
              f"({r['events_per_s_on']:.1f} events/s), {sec_off:.3f} s without "
              f"({r['events_per_s_off']:.1f} events/s)"
              + (f", sample mode {r['sample']['events_per_s']:.1f} events/s"
                 if "sample" in r else "")
              + f"; rows equal on/off; first call's records and resolutions equal "
              f"device='cpu'; launches {json.dumps(launches)}", flush=True)
    out["arena_d2h"] = arena_d2h_ms(torch)
    a = out["arena_d2h"]
    print(f"path LIN arena: record_batch of {a['rows']} rows ({a['bytes']} lane bytes) "
          f"{a['ms']:.3f} ms a publish ({a['GB_per_s']:.2f} GB/s)", flush=True)
    return out


# sharded execution (@app:shard; K49 the owner hash and fold, K50
# the routed pre-pass). The card is one H100: `mesh_devices` gives the 8
# shards of XLA_FLAGS' host device count, all on cuda:0, so every SH figure
# is 8 shards sharing one card, never 8 cards.
SH_SHARDS, SH_SYMBOLS, SH_BATCHES = 8, 1000, 8
SH_FLAG = f"--xla_force_host_platform_device_count={SH_SHARDS}"
SH_PART_APP = PT_APP.replace(
    "@app:partitionCapacity", "{head}@app:partitionCapacity")
SH_KEYS_APP = """@app:batch(size='{batch}')
{head}define stream StockStream (symbol string, price float, volume long);
@info(name='q') from StockStream select symbol, count() as n, max(price) as hi, sum(volume) as vol
group by symbol insert into Out;
"""
SH_BATCH_APP = """@app:batch(size='{batch}') @app:ingestChunk(size='{k}')
{head}define stream StockStream (symbol string, price float, volume long);
@info(name='q') from StockStream[price > 50] select symbol, price, volume insert into Out;
"""
SH_KERNELS = {"PART": ("pattern_place", "partition_length_window_step"),
              "ROUTED": ("shard_route", "partition_length_window_step"),
              "KEYS": ("shard_owner", "shard_fold"), "BATCH": ("wire_decode", "deliver_pack")}


def sh_data(n: int) -> tuple:
    """bench.py:_make_stock_data of seed 7 with 1,000 symbols (ids 1..1000)."""
    data = stock_data(n, seed=7)
    data["symbol"] = np.random.default_rng(7).integers(1, SH_SYMBOLS + 1, size=n).astype(np.int32)
    return data, [f"SYM{i:04d}" for i in range(SH_SYMBOLS)]


def sh_head(axis: str) -> str:
    return f"@app:shard(devices='{SH_SHARDS}', axis='{axis}')\n"


def run_sh(dev, app: str, data: dict, names, calls: list, fused: bool = True) -> dict:
    """Drive an SH app through send_columns, one call a (lo, hi) range,
    query "q" to a callback. Returns the rows (ts, data) in order, each
    call's seconds (host clock around a synchronize), the app's status."""
    import torch

    from siddhi_tpu_torch import SiddhiManager

    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(app)
    for s in names:
        mgr.interner.intern(s)
    rows: list = []
    rt.add_callback("q", lambda t, ins, rem: rows.extend(
        (e.timestamp, tuple(e.data)) for e in ins or []))
    rt.start()
    if not fused:
        rt.junctions["StockStream"].fused_ingest = None
    h = rt.get_input_handler("StockStream")
    secs = []
    for lo, hi in calls:
        if dev != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        h.send_columns(data["ts"][lo:hi], {k: data[k][lo:hi] for k in ("symbol", "price",
                                                                         "volume")}, now=0)
        if dev != "cpu":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    status = rt.snapshot_status()
    rt.shutdown()
    mgr.shutdown()
    return {"rows": rows, "seconds": secs, "status": status}


FOLD_SEED = 2049
PJ_VIEW_SEED = 2038  # tools/redesign_times.py's K38 ring at PJ's shape


def fold_timing_inputs(torch, dev) -> tuple:
    """K49's fold at SH-KEYS' shape (B=32,768, D=8, seed FOLD_SEED): each
    shard's own lanes of SH-KEYS' output kind {name: D [B] tensors} (int32,
    int64, float32 with NaN payloads and -0.0, bool), each shard's valid,
    and the owners (the rows' owner shards, uniform)."""
    rng = np.random.default_rng(FOLD_SEED)
    d, b = SH_SHARDS, MAIN_BATCH
    f = rng.uniform(-5, 5, (d, b)).astype(np.float32)
    f.view(np.int32)[:, ::5] = 0x7FC00001
    f.view(np.int32)[:, 1::7] = -0x80000000
    lanes = {"symbol": rng.integers(1, 1001, (d, b)).astype(np.int32),
             "n": rng.integers(0, 1 << 40, (d, b)), "hi": f,
             "vol": rng.integers(-(1 << 62), 1 << 62, (d, b)), "flag": rng.random((d, b)) < 0.5}
    valid = rng.random((d, b)) < 0.4
    owner = rng.integers(0, d, b).astype(np.int32)
    return ({k: [torch.from_numpy(v[i].copy()).to(dev) for i in range(d)]
             for k, v in lanes.items()},
            [torch.from_numpy(v.copy()).to(dev) for v in valid], torch.from_numpy(owner).to(dev))


def shard_kernel_phase(torch, dev) -> dict:
    """K49 (ks_owner, ks_fold) and K50 (sr_route) against their plain
    versions on the card, exactly: at path SH's shapes (B 32,768, D 8, P
    1,024; SH-KEYS' output lanes, the PT stream's lanes) and ragged (B 1, 33
    and 32,768, D 1, 2 and 8), keys at the INT64 edges, NaN payloads and
    -0.0 in float lanes, bool lanes, an all-TIMER batch. Times at SH's
    shapes; the library figures: one `torch.gather` a lane along D by the
    owner (the fold given the owners), and one stable `torch.argsort` of
    each row's device (the routing of the active rows, without the TIMER
    rows' broadcast to every device)."""
    from siddhi_tpu_torch.parallel.keyshard import fold_rows, fold_rows_ref, owner_of, owner_of_ref
    from siddhi_tpu_torch.parallel.mesh import route_rows, route_rows_ref

    rng = np.random.default_rng(17)
    edges = np.array([0, 1, -1, -(1 << 63), (1 << 63) - 1, -(1 << 63) + 1, (1 << 63) - 2],
                     np.int64)

    def keys_of(b):
        k = rng.integers(-(1 << 63), (1 << 63) - 1, b, dtype=np.int64, endpoint=True)
        k[:min(b, len(edges))] = edges[:b]
        return torch.from_numpy(k).to(dev)

    def fold_lanes(d, b):
        """Each shard's own [B] lanes, as the shards' selectors leave them:
        {name: D tensors}."""
        f = rng.uniform(-5, 5, (d, b)).astype(np.float32)
        f.view(np.int32)[:, ::5] = 0x7FC00001
        f.view(np.int32)[:, 1::7] = -0x80000000
        lanes = {"symbol": rng.integers(1, 1001, (d, b)).astype(np.int32),
                 "n": rng.integers(0, 1 << 40, (d, b)), "hi": f,
                 "vol": rng.integers(-(1 << 62), 1 << 62, (d, b)),
                 "flag": rng.random((d, b)) < 0.5}
        return {k: [torch.from_numpy(v[i].copy()).to(dev) for i in range(d)]
                for k, v in lanes.items()}

    def valid_of(d, b):
        return [torch.from_numpy(rng.random(b) < 0.4).to(dev) for _ in range(d)]

    def route_in(b, p, all_timer=False):
        slot = rng.integers(0, p + 1, b).astype(np.int32)
        active = rng.random(b) < 0.8
        timer = ~active & (rng.random(b) < 0.2)
        if all_timer:
            active[:], timer[:] = False, True
        d = stock_data(b, seed=int(rng.integers(1 << 30)))
        price = d["price"].copy()
        price.view(np.int32)[::9] = -0x80000000
        lanes = {"ts": d["ts"], "kind": np.where(timer, 2, 0).astype(np.int8),
                 "c.symbol": d["symbol"], "c.price": price, "c.volume": d["volume"]}
        return (torch.from_numpy(slot).to(dev), torch.from_numpy(active).to(dev),
                torch.from_numpy(timer).to(dev),
                {k: torch.from_numpy(v).to(dev) for k, v in lanes.items()})

    b_sh = MAIN_BATCH
    for b in (1, 33, b_sh):
        for d in (1, 2, SH_SHARDS):
            k = keys_of(b)
            same_bits(torch, [owner_of(k, d)], [owner_of_ref(k, d)])
            lanes = fold_lanes(d, b)
            owner = owner_of(keys_of(b), d)
            valid = valid_of(d, b)
            got, want = fold_rows(lanes, owner, valid), fold_rows_ref(lanes, owner, valid)
            same_bits(torch, [got[0], got[1]], [want[0], want[1]])
            for all_timer in (False, True):
                ins = route_in(b, 1024)
                if all_timer:
                    ins = route_in(b, 1024, all_timer=True)
                same_bits(torch, list(route_rows(*ins, 1024, d)), list(route_rows_ref(*ins, 1024, d)))
    # the fold's pointer table past its by-value size (a device table), and
    # rows of no owner
    for b, d in ((33, 70), (4097, 64)):
        lanes, valid = fold_lanes(d, b), valid_of(d, b)
        owner = owner_of(keys_of(b), d)
        owner[::11] = -1
        same_bits(torch, list(fold_rows(lanes, owner, valid)),
                  list(fold_rows_ref(lanes, owner, valid)))
    print("kernel check shard_owner, shard_fold and shard_route: B 1/33/32768 x D 1/2/8 "
          "(the fold also at D 64 and 70, a device pointer table, and rows of no owner), "
          "INT64 edges, NaN and -0.0 lanes, all-TIMER batches: exact", flush=True)

    keys = keys_of(b_sh)
    r_owner = {"max_abs_err": 0.0, "ms": time_ms(torch, lambda: owner_of(keys, SH_SHARDS), 200),
               "plain_ms": time_ms(torch, lambda: owner_of_ref(keys, SH_SHARDS), 200),
               "library_ms": None,
               # each key read once, each owner written once
               "bound_ms": (8 + 4) * b_sh / MEM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    lanes, valid, owner = fold_timing_inputs(torch, dev)
    lane_bytes = sum(x[0].element_size() for x in lanes.values())
    idx = owner.long()[None, :]
    stacked = [torch.stack(x) for x in lanes.values()]

    def stacks():  # what the callers built before the fold read the shards in place
        return [torch.stack(x) for x in lanes.values()] + [torch.stack(valid)]

    # three ways (`three_times`), beside a `torch.gather` a lane along D by
    # the owner over lanes stacked beforehand (the fold given the owners and
    # the stacks), and the stacks alone
    r_fold = {"max_abs_err": 0.0,
              **three_times(torch, lambda: fold_rows(lanes, owner, valid), 200,
                            ("fold_kernel(",)),
              "plain_ms": time_ms(torch, lambda: fold_rows_ref(lanes, owner, valid), 50),
              "library": three_times(torch, lambda: [torch.gather(x, 0, idx) for x in stacked],
                                     200, None),
              "stacks": three_times(torch, stacks, 200, None),
              # the shards' lanes (the owner's element a lane), every
              # shard's valid and the owners read once; [B] lanes and valid
              # written once
              "bound_ms": ((b_sh * lane_bytes + SH_SHARDS * b_sh + 4 * b_sh)
                           + b_sh * (lane_bytes + 1)) / MEM_BYTES_PER_S * 1e3,
              "bound_by": "bytes", "lanes": len(lanes)}
    r_fold["library_ms"] = r_fold["library"]["ms"]
    print(f"kernel shard_fold B={b_sh} D={SH_SHARDS}: ms={r_fold['ms']:.4f} "
          f"device_ms={r_fold['device_ms']:.4f} kernel_ms={fmt(r_fold['kernel_ms'])}; "
          f"torch.gather a lane {r_fold['library']['ms']:.4f}/"
          f"{r_fold['library']['device_ms']:.4f}/{fmt(r_fold['library']['kernel_ms'])}; "
          f"the stacks {r_fold['stacks']['ms']:.4f}/{r_fold['stacks']['device_ms']:.4f}/"
          f"{fmt(r_fold['stacks']['kernel_ms'])}", flush=True)
    ins = route_in(b_sh, 1024)
    slot, active, timer, rl = ins
    dev_of = torch.where(active & (slot < 1024), slot % SH_SHARDS, SH_SHARDS)
    in_bytes = sum(x.element_size() for x in rl.values())
    r_route = {"max_abs_err": 0.0,
               "ms": time_ms(torch, lambda: route_rows(*ins, 1024, SH_SHARDS), 200),
               "plain_ms": time_ms(torch, lambda: route_rows_ref(*ins, 1024, SH_SHARDS), 50),
               "library_ms": time_ms(torch, lambda: torch.argsort(dev_of, stable=True), 200),
               # slot, active and timer masks and every lane read once; the
               # [D, B] routed indices, slot, valid and lanes written once
               "bound_ms": (b_sh * (4 + 1 + 1 + in_bytes)
                            + SH_SHARDS * b_sh * (4 + 4 + 1 + in_bytes)) / MEM_BYTES_PER_S * 1e3,
               "bound_by": "bytes"}
    for name, r in (("shard_owner", r_owner), ("shard_fold", r_fold), ("shard_route", r_route)):
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"kernel {name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.6f} (bytes) library_ms={lib} max_abs_err=0.0 "
              f"(B {b_sh}, D {SH_SHARDS})", flush=True)
    return {"shard_owner": r_owner, "shard_fold": r_fold, "shard_route": r_route}


def sh_rows_np(out) -> np.ndarray:
    """A step's valid rows as a record array sorted by every exact lane."""
    v = out.valid.cpu().numpy()
    lanes = {"ts": out.ts.cpu().numpy()[v], "kind": out.kind.cpu().numpy()[v]}
    lanes.update({n: c.cpu().numpy()[v] for n, c in out.cols.items()})
    exact = [k for k, x in lanes.items() if x.dtype.kind != "f"]
    order = np.lexsort([lanes[k] for k in reversed(exact)])
    return {k: x[order] for k, x in lanes.items()}


def sh_routed(torch, data: dict, names, steps: int, dev: str = "cuda") -> dict:
    """SH-ROUTED: PT's per-key length window query ("pw") as a routed
    sharded step (parallel/mesh.py `shard_partitioned_query`, K50) and as
    the unsharded keyed step, on the same batches: each step's rows
    set-equal (exact lanes equal, floats within 2e-4), K50 once a step."""
    from siddhi_tpu_torch import SiddhiManager, kernels
    from siddhi_tpu_torch.parallel.mesh import mesh_devices, shard_partitioned_query

    b = MAIN_BATCH
    app = SH_PART_APP.format(batch=b, cap=PT_CAP, w=PT_W, head="")
    mgr = SiddhiManager(device=dev)
    for s in names:
        mgr.interner.intern(s)
    rt = mgr.create_siddhi_app_runtime(app)
    rt.start()
    qr = rt.queries["pw"]
    schema = qr.in_schema
    devices = mesh_devices(dev)
    if len(devices) != SH_SHARDS or any(d != devices[0] for d in devices):
        raise AssertionError(f"path SH: mesh_devices gave {devices}")
    cols = ("symbol", "price", "volume")
    batches = [schema.to_batch_cols(data["ts"][i * b:(i + 1) * b],
                                    {k: data[k][i * b:(i + 1) * b] for k in cols},
                                    mgr.interner, dev, capacity=b) for i in range(steps)]
    ptable = dict(rt.partitions[0].ptable)
    state = qr.init_state()
    sq = shard_partitioned_query(qr, devices, routed=True)
    sq.step(batches[0], 0)  # warm-up, not counted
    sq = shard_partitioned_query(qr, devices, routed=True)
    launches: collections.Counter = collections.Counter()
    routed_s = plain_s = 0.0
    rows = 0
    for i, bt in enumerate(batches):
        now = int(data["ts"][(i + 1) * b - 1])
        sync = torch.cuda.synchronize if dev != "cpu" else (lambda: None)
        sync()
        kernels.launches.clear()  # the routed step's launches alone
        t0 = time.perf_counter()
        outs, aux = sq.step(bt, now)
        sync()
        routed_s += time.perf_counter() - t0
        launches.update(kernels.launches)
        t0 = time.perf_counter()
        ptable, state, want, _ctx = qr._pstep_outer(ptable, state, bt,
                                                    torch.tensor(now, device=dev))
        sync()
        plain_s += time.perf_counter() - t0
        g, w = sh_rows_np(outs), sh_rows_np(want)
        if set(g) != set(w) or any(not np.array_equal(g[k], w[k]) for k in g
                                   if g[k].dtype.kind != "f") or not all(
                np.allclose(g[k], w[k], rtol=RTOL, atol=RTOL, equal_nan=True)
                for k in g if g[k].dtype.kind == "f"):
            raise AssertionError(f"path SH-ROUTED: step {i}'s rows differ from the unsharded step's")
        rows += len(w["ts"])
    rt.shutdown()
    mgr.shutdown()
    return {"steps": steps, "events": steps * b, "rows": rows, "launches": dict(launches),
            "seconds": routed_s, "seconds_off": plain_s,
            "events_per_s": steps * b / routed_s, "events_per_s_off": steps * b / plain_s}


def shard_path_phase(torch, dev: str = "cuda") -> dict:
    """Path SH: the port's sharded execution at full width, B 32,768, 1,000
    symbols of seed 7, `mesh_devices` giving 8 shards on cuda:0 (XLA_FLAGS'
    host device count 8; 8 shards share one H100). SH-PART: PT's
    partitioned app under @app:shard(devices='8', axis='part') (1,024 slots,
    128 a shard), its rows equal in order to the unsharded app's; SH-ROUTED:
    the routed step of PT's window query on the same feed, each step's rows
    set-equal to the unsharded step's; SH-KEYS: a count/max/sum group-by
    over the symbols under axis='keys', rows byte-identical to sharding
    off; SH-BATCH: a filter under axis='batch' in fused calls of 8 batches
    (one a shard), rows byte-identical to sharding off. Each sharded run's
    launch counts from 0 just before it (after a warm-up call); events/s
    sharded and off. K49's launches come from SH-KEYS, K50's from
    SH-ROUTED."""
    from siddhi_tpu_torch import kernels

    b = MAIN_BATCH
    n = SH_BATCHES * b
    data, names = sh_data(n)
    saved = os.environ.get("XLA_FLAGS")
    os.environ["XLA_FLAGS"] = SH_FLAG
    out: dict = {"shards": SH_SHARDS, "card": card_line()}
    try:
        calls = [(i * b, (i + 1) * b) for i in range(SH_BATCHES)]
        part = SH_PART_APP.format(batch=b, cap=PT_CAP, w=PT_W, head="{head}")
        keys = SH_KEYS_APP.format(batch=b, head="{head}")
        routed_batches = SH_BATCH_APP.format(batch=b, k=SH_BATCHES, head="{head}")
        for label, app, axis, runs in (("PART", part, "part", calls),
                                       ("KEYS", keys, "keys", calls),
                                       ("BATCH", routed_batches, "batch", [(0, n), (0, n)])):
            sharded = app.replace("{head}", sh_head(axis))
            plain = app.replace("{head}", "")
            run_sh(dev, sharded, data, names, runs[:1])  # warm-up, not counted
            kernels.launches.clear()
            on = run_sh(dev, sharded, data, names, runs)
            launches = dict(kernels.launches)
            off = run_sh(dev, plain, data, names, runs)
            for k in SH_KERNELS[label]:
                if launches.get(k, 0) <= 0 and dev != "cpu":
                    raise AssertionError(f"path SH-{label}: kernel {k} was not launched")
            if label == "PART":
                same = on["rows"] == off["rows"]
                if not on["rows"] or not rows_match([r for _t, r in on["rows"]],
                                                    [r for _t, r in off["rows"]]) or [
                        t for t, _r in on["rows"]] != [t for t, _r in off["rows"]]:
                    raise AssertionError("path SH-PART: rows differ from the unsharded app's")
            else:
                same = on["rows"] == off["rows"]
                if not same or not on["rows"]:
                    raise AssertionError(f"path SH-{label}: rows not byte-identical to "
                                         "sharding off")
            shard = on["status"].get("shard", {})
            if shard.get("devices") != SH_SHARDS:
                raise AssertionError(f"path SH-{label}: sharding not armed: {shard}")
            ev = sum(hi - lo for lo, hi in runs)
            timed = runs[1:] if label == "BATCH" else runs
            t_on = sum(on["seconds"][len(runs) - len(timed):])
            t_off = sum(off["seconds"][len(runs) - len(timed):])
            ev_t = sum(hi - lo for lo, hi in timed)
            r = {"events": ev, "rows": len(on["rows"]), "launches": launches,
                 "rows_exactly_equal": same, "seconds": t_on, "seconds_off": t_off,
                 "events_per_s": ev_t / t_on, "events_per_s_off": ev_t / t_off,
                 "placement": {k: v for k, v in shard.items() if k != "devices"}}
            out[label] = r
            print(f"path SH-{label}: {ev} events, {r['rows']} rows equal to sharding off"
                  f"{' (byte for byte)' if same else ' (floats within 2e-4)'}; "
                  f"{r['events_per_s']:.1f} events/s sharded ({SH_SHARDS} shards sharing one "
                  f"card), {r['events_per_s_off']:.1f} events/s off; launches "
                  f"{json.dumps(launches)}", flush=True)
            if label == "PART":
                routed = sh_routed(torch, data, names, SH_BATCHES, dev)
                out["ROUTED"] = routed
                if routed["launches"].get("shard_route", 0) != SH_BATCHES and dev != "cpu":
                    raise AssertionError(f"path SH-ROUTED: {routed['launches']} — K50 not "
                                         "launched once a step")
                print(f"path SH-ROUTED: {routed['events']} events in {routed['steps']} steps, "
                      f"{routed['rows']} rows set-equal to the unsharded step's; "
                      f"{routed['events_per_s']:.1f} events/s routed ({SH_SHARDS} shards "
                      f"sharing one card), {routed['events_per_s_off']:.1f} events/s "
                      f"unsharded; launches {json.dumps(routed['launches'])}", flush=True)
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    print(f"path SH: every figure is {SH_SHARDS} virtual shards sharing one card "
          f"({out['card']}), not {SH_SHARDS} cards", flush=True)
    return out


def same_tree_np(got, want, what: str) -> None:
    """Two numpy trees equal leaf for leaf (floats by their bits)."""
    for g, w in zip(flat(got), flat(want), strict=True):
        g, w = np.atleast_1d(np.asarray(g)), np.atleast_1d(np.asarray(w))
        if g.shape != w.shape or g.dtype != w.dtype or not np.array_equal(
                g.view(np.uint8) if g.dtype != bool else g,
                w.view(np.uint8) if w.dtype != bool else w):
            raise AssertionError(f"{what}: differs from device='cpu'")


def verify_phase(dev) -> None:
    from siddhi_tpu_torch import SiddhiManager

    with open(os.path.join(ROOT, "VERIFY.json")) as f:
        frozen = json.load(f)["cpu"]
    # the 96-event feed of bench.py:_leg_verify
    rng = np.random.default_rng(99)
    ts = np.arange(96, dtype=np.int64) * 7 + 1_700_000_000_000
    rows = [
        (["WSO2", "IBM", "GOOG", "MSFT"][int(rng.integers(0, 4))],
         float(np.round(rng.uniform(0.0, 100.0), 3)), int(rng.integers(1, 1000)))
        for _ in range(96)
    ]
    for case, ql in VERIFY_CASES.items():
        mgr = SiddhiManager(device=dev)
        rt = mgr.create_siddhi_app_runtime(ql)
        got = []
        rt.add_callback("q", lambda t, ins, rem, _g=got: _g.extend(
            [["+"] + list(e.data) for e in (ins or [])]
            + [["-"] + list(e.data) for e in (rem or [])]))
        rt.start()
        h = rt.get_input_handler("S")
        for i, r in enumerate(rows):
            h.send(r, timestamp=int(ts[i]))
        rt.shutdown()
        if not rows_match(got, frozen[case]):
            raise AssertionError(f"verify case {case}: rows differ from VERIFY.json")
        print(f"verify {case}: {len(got)} rows match VERIFY.json", flush=True)
    for case, (ql, sq) in VERIFY_TABLE_CASES.items():
        mgr = SiddhiManager(device=dev)
        rt = mgr.create_siddhi_app_runtime(ql)
        rt.start()
        h = rt.get_input_handler("S")
        for i, r in enumerate(rows):
            h.send(r, timestamp=int(ts[i]))
        got = sorted(list(e.data) for e in rt.query(sq))
        rt.shutdown()
        if not rows_match(got, frozen[case]):
            raise AssertionError(f"verify case {case}: store-query rows differ from VERIFY.json")
        print(f"verify {case}: {len(got)} store-query rows match VERIFY.json", flush=True)
    per_dev = {}
    for d in (dev, "cpu"):
        mgr = SiddhiManager(device=d)
        rt = mgr.create_siddhi_app_runtime(MULTI_QUERY_CASE)
        got = per_dev[d] = {q: [] for q in rt.queries}
        for q in rt.queries:
            rt.add_callback(q, lambda t, ins, rem, _g=got[q]: _g.extend(
                [["+"] + list(e.data) for e in (ins or [])]
                + [["-"] + list(e.data) for e in (rem or [])]))
        rt.start()
        h = rt.get_input_handler("S")
        for i, r in enumerate(rows):
            h.send(r, timestamp=int(ts[i]))
        rt.shutdown()
    for q, want in per_dev["cpu"].items():
        if not want or not rows_match(per_dev[dev][q], want):
            raise AssertionError(f"verify case multi_query_shared: query {q} differs from "
                                 "device='cpu'")
    print("verify multi_query_shared: "
          + ", ".join(f"{q} {len(r)} rows" for q, r in per_dev["cpu"].items())
          + " match device='cpu'", flush=True)


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------


def main_app(extra: str) -> str:
    return MAIN_APP.format(batch=MAIN_BATCH, w=MAIN_W, extra=extra)


def run_app(dev, app: str, data: dict, n_events: int, stride: int, first_call: int,
            fused: bool = True, keep_calls: int = 1, symbols=SYMBOLS, fires=None,
            cols=("symbol", "price", "volume")):
    """Drive one app through send_columns, in calls of `first_call` events
    and then `stride`; with fused=False the fused engines are detached, so
    every call takes the per-batch path. Returns (delivered row count, rows
    delivered by each of the first `keep_calls` calls, seconds, the fused
    engine's counters or None). With `fires` (a one-element list), the
    scheduler's timer targets are wrapped and their completed fires added
    to fires[0]."""
    import torch

    from siddhi_tpu_torch import SiddhiManager

    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(app)
    for s in symbols:
        mgr.interner.intern(s)
    count = [0]
    kept: list = []

    def on_rows(t, ins, rem):
        count[0] += len(ins or [])
        if len(kept) <= keep_calls:
            kept[-1].extend(tuple(e.data) for e in ins or [])

    rt.add_callback("q", on_rows)
    if fires is not None:
        targets = rt.queries["q"].timer_targets
        for key, fire in list(targets.items()):
            def counted(t_ms, _fire=fire):
                _fire(t_ms)
                fires[0] += 1

            targets[key] = counted
    rt.start()
    j = rt.junctions["StockStream"]
    if not fused:
        j.fused_ingest = None
    elif j.fused_ingest is None:
        raise AssertionError("no fused ingest engine on StockStream")
    h = rt.get_input_handler("StockStream")
    if dev != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    sent = 0
    while sent < n_events:
        end = min(sent + (first_call if sent == 0 else stride), n_events)
        kept.append([])
        h.send_columns(data["ts"][sent:end], {k: data[k][sent:end] for k in cols}, now=0)
        sent = end
    if dev != "cpu":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fi = j.fused_ingest
    info = fi.describe_state() if fi is not None else None
    rt.shutdown()
    mgr.shutdown()
    return count[0], kept[:keep_calls], dt, info


FUSED_KERNELS = ("length_window_step", "running_sum", "window_extreme", "wire_decode",
                 "deliver_pack")


def main_path_phase(torch) -> dict:
    from siddhi_tpu_torch import kernels

    b = MAIN_BATCH
    data = stock_data(MAIN_EVENTS, seed=7)
    first_n, stride = 4 * b, 8 * b
    prefix_calls, prefix_events = 3, 20 * b  # calls of 4, 8 and 8 batches
    # warm-up on a short prefix (allocator, pinned pool, drain worker, first
    # launches), two fused calls of 2 batches; not counted
    run_app("cuda", main_app(MINMAX), data, 4 * b, 2 * b, 2 * b)
    kernels.launches.clear()
    torch.cuda.reset_peak_memory_stats()
    out, prefixes = {}, {}
    for name, extra in (("filter_window_avg", ""), ("filter_window_minmax", MINMAX)):
        n_rows, kept, dt, info = run_app("cuda", main_app(extra), data, MAIN_EVENTS, stride,
                                         first_n, keep_calls=prefix_calls)
        prefixes[name] = kept
        out[name] = {"events": MAIN_EVENTS, "rows": n_rows, "seconds": dt,
                     "events_per_s": MAIN_EVENTS / dt, "chunks": info["chunks"],
                     "batches": info["batches"], "chunk_K": "4 (first call), then 8",
                     "wire": info["wire"]}
        # every call of at least 2 batches takes the fused path; the short
        # last call (33,920 events) takes the per-batch path
        calls = [first_n] + [stride] * ((MAIN_EVENTS - first_n) // stride)
        calls.append(MAIN_EVENTS - sum(calls))
        want = sum(c for c in calls if c >= 2 * b)
        if info["events"] != want:
            raise AssertionError(f"{name}: fused path took {info['events']} events, "
                                 f"expected {want}")
        out[name]["fused_events"] = want
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    print(f"main path launches {json.dumps(launches)}; peak device memory "
          f"{peak} bytes", flush=True)
    for k in FUSED_KERNELS:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    for name, r in out.items():
        extra = MINMAX if "minmax" in name else ""
        # the first batch on the host (the plain K3 is O(rows x elements)):
        # its rows lead the first fused call's, the window's rows in order
        _n, cpu_first, _dt, _i = run_app("cpu", main_app(extra), data, b, b, b)
        cpu_rows = cpu_first[0]
        if not cpu_rows or not rows_match(prefixes[name][0][:len(cpu_rows)], cpu_rows):
            raise AssertionError(f"{name}: the first batch differs from device='cpu'")
        pb_rows, pb_kept, pb_dt, _i = run_app("cuda", main_app(extra), data, prefix_events, stride,
                                              first_n, fused=False, keep_calls=prefix_calls)
        fused_prefix = [row for call in prefixes[name] for row in call]
        pb_prefix = [row for call in pb_kept for row in call]
        if not pb_prefix or not rows_match(fused_prefix, pb_prefix):
            raise AssertionError(f"{name}: fused rows differ from the per-batch form")
        r["per_batch"] = {"events": prefix_events, "rows": pb_rows, "seconds": pb_dt,
                          "events_per_s": prefix_events / pb_dt,
                          "rows_exactly_equal": fused_prefix == pb_prefix}
        print(f"main path {name}: fused {r['events']} events, {r['rows']} rows delivered, "
              f"{r['seconds']:.3f} s, {r['events_per_s']:.1f} events/s, {r['chunks']} chunks "
              f"(K=4 first, then 8); per-batch form {prefix_events} events, {pb_rows} rows, "
              f"{pb_dt:.3f} s, {prefix_events / pb_dt:.1f} events/s; the first batch matches "
              f"device='cpu', first 20 batches match the per-batch form "
              f"(exactly: {fused_prefix == pb_prefix}); wire {r['wire']['lanes']} "
              f"{r['wire']['encoded_B_per_ev']} B/event", flush=True)
    return {"apps": out, "launches": launches, "peak_bytes": peak}


GROUP_KERNELS = ("batch_window_step", "assign_slots", "keyed_running_sum", "keep_last",
                 "wire_decode", "deliver_pack")


def grouped_path_phase(torch) -> dict:
    """tumbling_groupby at full width: 2,000,000 events of seed 7 through
    send_columns, fused, in calls of 8 batches (the first of 4); launch
    counts of this run alone; the first 4 batches against device="cpu" and
    the first 20 against the per-batch form. Then 1,000 distinct symbols for
    4 batches against device="cpu"."""
    from siddhi_tpu_torch import kernels

    b = MAIN_BATCH
    app = GROUP_APP.format(batch=b, n=GROUP_N)
    data = stock_data(MAIN_EVENTS, seed=7)
    first_n, stride = 4 * b, 8 * b
    prefix_calls, prefix_events = 3, 20 * b
    run_app("cuda", app, data, 4 * b, 2 * b, 2 * b)  # warm-up, not counted
    kernels.launches.clear()
    n_rows, kept, dt, info = run_app("cuda", app, data, MAIN_EVENTS, stride, first_n,
                                     keep_calls=prefix_calls)
    launches = dict(kernels.launches)
    print(f"tumbling_groupby launches {json.dumps(launches)}", flush=True)
    for k in GROUP_KERNELS:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} was not launched on the tumbling_groupby path")
    _n, cpu_first, _dt, _i = run_app("cpu", app, data, first_n, first_n, first_n)
    if not cpu_first[0] or not rows_match(kept[0], cpu_first[0]):
        raise AssertionError("tumbling_groupby: first 4 batches differ from device='cpu'")
    pb_rows, pb_kept, pb_dt, _i = run_app("cuda", app, data, prefix_events, stride, first_n,
                                          fused=False, keep_calls=prefix_calls)
    fused_prefix = [row for call in kept for row in call]
    pb_prefix = [row for call in pb_kept for row in call]
    if not pb_prefix or not rows_match(fused_prefix, pb_prefix):
        raise AssertionError("tumbling_groupby: fused rows differ from the per-batch form")
    out = {"events": MAIN_EVENTS, "rows": n_rows, "seconds": dt,
           "events_per_s": MAIN_EVENTS / dt, "chunks": info["chunks"], "batches": info["batches"],
           "wire": info["wire"], "launches": launches,
           "per_batch": {"events": prefix_events, "rows": pb_rows, "seconds": pb_dt,
                         "events_per_s": prefix_events / pb_dt,
                         "rows_exactly_equal": fused_prefix == pb_prefix}}
    print(f"main path tumbling_groupby: fused {MAIN_EVENTS} events, {n_rows} rows delivered, "
          f"{dt:.3f} s, {MAIN_EVENTS / dt:.1f} events/s, {info['chunks']} chunks; per-batch "
          f"form {prefix_events} events, {pb_rows} rows, {pb_dt:.3f} s, "
          f"{prefix_events / pb_dt:.1f} events/s; first 4 batches match device='cpu', first 20 "
          f"batches match the per-batch form (exactly: {fused_prefix == pb_prefix}); wire "
          f"{info['wire']['lanes']} {info['wire']['encoded_B_per_ev']} B/event", flush=True)

    # 1,000 distinct symbols, 4 batches in one call (fused), against the CPU
    names = [f"SYM{i:04d}" for i in range(1000)]
    hc = stock_data(4 * b, seed=8)
    hc["symbol"] = np.random.default_rng(8).integers(1, 1001, size=4 * b).astype(np.int32)
    n_hc, hc_cuda, _dt, _i = run_app("cuda", app, hc, 4 * b, 4 * b, 4 * b, symbols=names)
    _n, hc_cpu, _dt, _i = run_app("cpu", app, hc, 4 * b, 4 * b, 4 * b, symbols=names)
    if not hc_cpu[0] or not rows_match(hc_cuda[0], hc_cpu[0]):
        raise AssertionError("tumbling_groupby, 1,000 symbols: rows differ from device='cpu'")
    out["symbols_1000"] = {"events": 4 * b, "rows": n_hc}
    print(f"tumbling_groupby with 1,000 symbols: {4 * b} events, {n_hc} rows, match "
          "device='cpu'", flush=True)

    # the same feed at @app:groupCapacity(size='512'): buckets hold ~640
    # distinct symbols, so the table overflows; the flag is read off the
    # dispatch path (or at shutdown) and logged once, and the rows still
    # equal the CPU's
    small = f"@app:groupCapacity(size='{GROUP_N // 2}')\n" + app
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger("siddhi_tpu_torch").addHandler(handler)
    try:
        n_ov, ov_cuda, _dt, _i = run_app("cuda", small, hc, 4 * b, 4 * b, 4 * b, symbols=names)
    finally:
        logging.getLogger("siddhi_tpu_torch").removeHandler(handler)
    _n, ov_cpu, _dt, _i = run_app("cpu", small, hc, 4 * b, 4 * b, 4 * b, symbols=names)
    logged = sum("overflowed" in r.getMessage() for r in records)
    if logged != 1 or not rows_match(ov_cuda[0], ov_cpu[0]):
        raise AssertionError(f"group capacity 512: {logged} overflow logs, rows equal to "
                             f"device='cpu': {rows_match(ov_cuda[0], ov_cpu[0])}")
    out["capacity_512_overflow"] = {"rows": n_ov, "overflow_logs": logged}
    print(f"tumbling_groupby at groupCapacity {GROUP_N // 2} with 1,000 symbols: {n_ov} rows match "
          "device='cpu', overflow logged once", flush=True)

    # forms outside the slice are refused on the card too, at app creation
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core.errors import SiddhiAppCreationError

    for q in ("@OnError(action='LOG') define table T (symbol string); "
              "from S select symbol insert into T",
              "@async(buffer.size='64') define stream S7 (a int); "
              "from S7 select a insert into O7",
              "@OnError(action='LOG') define window W (symbol string) length(4); "
              "from S select symbol insert into W",
              "@source(type='inMemory', topic='t') define stream S9 (a int); "
              "from S select symbol insert into Out"):
        try:
            SiddhiManager(device="cuda").create_siddhi_app_runtime(VERIFY_HEAD + q + ";")
        except SiddhiAppCreationError as e:
            if "not ported yet" not in str(e):
                raise
        else:
            raise AssertionError(f"not refused on the card: {q}")
    print("forms outside the slice raise 'not ported yet' on the card", flush=True)
    return out


JOIN_KERNELS = ("length_window_step", "ring_view", "join_assemble", "wire_decode", "deliver_pack")
TIME_JOIN_KERNELS = ("time_window_step", "ring_view", "join_assemble")
TIME_AGG_KERNELS = ("time_window_step", "running_sum", "window_extreme")


def capture_warnings(fn, needle: str = "joinCapacity"):
    """Run fn() and return (its result, the warnings logged that name
    `needle`: the join's or the pattern's overflow)."""
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger("siddhi_tpu_torch")
    log.addHandler(handler)
    try:
        out = fn()
    finally:
        log.removeHandler(handler)
    return out, [r for r in records if needle in r.getMessage()]


def check_path(name, launches, wanted, kept, cpu_kept, calls):
    """Every kernel of the path launched, and the first `calls` calls' rows
    equal to the same run on device="cpu"."""
    for k in wanted:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} was not launched on the {name} path")
    got = [row for call in kept[:calls] for row in call]
    want = [row for call in cpu_kept[:calls] for row in call]
    if not want or not rows_match(got, want):
        raise AssertionError(f"{name}: the first batches differ from device='cpu'")


def check_fires(name, fires, launches, data_steps) -> int:
    """Every timer fire of the run completed one time-window step: the
    step's launches are the data steps' plus the fires (a failed fire
    raises out of send_columns instead)."""
    steps = launches.get("time_window_step", 0)
    if fires <= 0 or steps != data_steps + fires:
        raise AssertionError(f"{name}: {fires} timer fires completed, but {steps} time-window "
                             f"steps launched for {data_steps} data steps")
    return fires


def join_path_phase(torch) -> dict:
    """Path J, sliding_join (bench.py:185, BASELINE.json config 3): the
    length(100) self-join on volume at @app:batch 8192, joinCapacity 8192,
    2,000,000 events of seed 7 through send_columns in calls of 8 batches
    (the first of 4), fused (the self-join's endpoint runs the left then
    the right half, and delivers both); launch counts of this run alone; no
    join overflow; the first 4 batches against device="cpu" and the first 20
    against the per-batch form, exactly."""
    from siddhi_tpu_torch import kernels

    b = JOIN_BATCH
    app = SLIDING_JOIN_APP
    data = stock_data(JOIN_EVENTS, seed=7)
    first_n, stride = 4 * b, 8 * b
    prefix_calls, prefix_events = 3, 20 * b
    run_app("cuda", app, data, 4 * b, 2 * b, 2 * b)  # warm-up, not counted
    kernels.launches.clear()
    (n_rows, kept, dt, info), warned = capture_warnings(
        lambda: run_app("cuda", app, data, JOIN_EVENTS, stride, first_n, keep_calls=prefix_calls))
    launches = dict(kernels.launches)
    print(f"sliding_join launches {json.dumps(launches)}", flush=True)
    if warned:
        raise AssertionError("sliding_join: the join output overflowed its capacity")
    _n, cpu_first, _dt, _i = run_app("cpu", app, data, first_n, first_n, first_n)
    check_path("sliding_join", launches, JOIN_KERNELS, kept, cpu_first, 1)
    pb_rows, pb_kept, pb_dt, _i = run_app("cuda", app, data, prefix_events, stride, first_n,
                                          fused=False, keep_calls=prefix_calls)
    fused_prefix = [row for call in kept for row in call]
    pb_prefix = [row for call in pb_kept for row in call]
    if not pb_prefix or fused_prefix != pb_prefix:
        raise AssertionError("sliding_join: fused rows differ from the per-batch form")
    n_batches = -(-JOIN_EVENTS // b)
    per_side = n_rows / (2 * n_batches)
    out = {"events": JOIN_EVENTS, "rows": n_rows, "seconds": dt, "events_per_s": JOIN_EVENTS / dt,
           "chunks": info["chunks"], "batches": info["batches"], "wire": info["wire"],
           "launches": launches, "matches_per_side_per_batch": per_side,
           "per_batch": {"events": prefix_events, "rows": pb_rows, "seconds": pb_dt,
                         "events_per_s": prefix_events / pb_dt, "rows_exactly_equal": True}}
    print(f"path J sliding_join: fused {JOIN_EVENTS} events, {n_rows} rows delivered "
          f"({per_side:.1f} matches per side per batch), {dt:.3f} s, {JOIN_EVENTS / dt:.1f} "
          f"events/s, {info['chunks']} chunks; per-batch form {prefix_events} events, {pb_rows} "
          f"rows, {pb_dt:.3f} s, {prefix_events / pb_dt:.1f} events/s; no overflow; first 4 "
          "batches match device='cpu', first 20 batches exactly equal the per-batch form",
          flush=True)
    return out


def time_join_path_phase(torch) -> dict:
    """Path T: the same self-join over time(1 sec) windows under
    @app:playback, joinCapacity 16384: 16,384 events of seed 7 through
    send_columns one batch of 8192 per call, the per-batch form (a query
    whose window needs the scheduler stays off the fused path); the
    event-time clock fires the TIMER rows before each call's batch; launch
    counts of this run alone; no join overflow; the first 2 calls against
    device="cpu"."""
    from siddhi_tpu_torch import kernels

    b = JOIN_BATCH
    app = TIME_JOIN_APP
    data = stock_data(TIME_JOIN_EVENTS, seed=7)
    run_app("cuda", app, data, 2 * b, b, b, fused=False)  # warm-up, not counted
    fires = [0]
    kernels.launches.clear()
    (n_rows, kept, dt, _info), warned = capture_warnings(
        lambda: run_app("cuda", app, data, TIME_JOIN_EVENTS, b, b, fused=False, keep_calls=4,
                        fires=fires))
    launches = dict(kernels.launches)
    print(f"time join launches {json.dumps(launches)}", flush=True)
    if warned:
        raise AssertionError("time join: the join output overflowed its capacity")
    _n, cpu_first, _dt, _i = run_app("cpu", app, data, 2 * b, b, b, fused=False, keep_calls=2)
    check_path("time join", launches, TIME_JOIN_KERNELS, kept, cpu_first, 2)
    n_batches = -(-TIME_JOIN_EVENTS // b)
    timer_steps = check_fires("time join", fires[0], launches, 2 * n_batches)
    per_side = n_rows / (2 * n_batches)
    out = {"events": TIME_JOIN_EVENTS, "rows": n_rows, "seconds": dt,
           "events_per_s": TIME_JOIN_EVENTS / dt, "batches": n_batches,
           "timer_steps": timer_steps, "matches_per_side_per_batch": per_side,
           "launches": launches}
    print(f"path T time-window join: {TIME_JOIN_EVENTS} events in {n_batches} batches and "
          f"{timer_steps} one-row TIMER steps, {n_rows} rows delivered ({per_side:.1f} matches "
          f"per side per batch), {dt:.3f} s, {TIME_JOIN_EVENTS / dt:.1f} events/s; no overflow; "
          "first 2 batches match device='cpu'", flush=True)
    return out


def time_agg_path_phase(torch) -> dict:
    """Path T2: StockStream[price > 50]#window.time(1 sec) with avg/min/max
    under @app:playback at @app:batch 32768, 4 batches one per call
    (per-batch form); launch counts of this run alone; the first 2 calls
    against device="cpu"."""
    from siddhi_tpu_torch import kernels

    b = MAIN_BATCH
    n = TIME_AGG_BATCHES * b
    data = stock_data(n, seed=7)
    run_app("cuda", TIME_AGG_APP, data, 2 * b, b, b, fused=False)  # warm-up, not counted
    fires = [0]
    kernels.launches.clear()
    n_rows, kept, dt, _info = run_app("cuda", TIME_AGG_APP, data, n, b, b, fused=False,
                                      keep_calls=4, fires=fires)
    launches = dict(kernels.launches)
    print(f"time aggregate launches {json.dumps(launches)}", flush=True)
    _n, cpu_first, _dt, _i = run_app("cpu", TIME_AGG_APP, data, 2 * b, b, b, fused=False,
                                     keep_calls=2)
    check_path("time aggregate", launches, TIME_AGG_KERNELS, kept, cpu_first, 2)
    timer_steps = check_fires("time aggregate", fires[0], launches, TIME_AGG_BATCHES)
    out = {"events": n, "rows": n_rows, "seconds": dt, "events_per_s": n / dt,
           "timer_steps": timer_steps, "launches": launches}
    print(f"path T2 time-window aggregate: {n} events in {TIME_AGG_BATCHES} batches and "
          f"{timer_steps} one-row TIMER steps, {n_rows} rows delivered, {dt:.3f} s, "
          f"{n / dt:.1f} events/s; first 2 batches match device='cpu'", flush=True)
    return out


def fused_busy(torch, app: str, data: dict, b: int, cols=("symbol", "price", "volume"),
               symbols=SYMBOLS) -> tuple:
    """Device busy share of one fused call of 8 batches (after a warm-up
    call of 2), from torch.profiler: (wall ms, device busy ms)."""
    from torch.profiler import ProfilerActivity, profile

    from siddhi_tpu_torch import SiddhiManager

    mgr = SiddhiManager()
    rt = mgr.create_siddhi_app_runtime(app)
    for s in symbols:
        mgr.interner.intern(s)
    rows = [0]
    rt.add_callback("q", lambda t, ins, rem: rows.__setitem__(0, rows[0] + len(ins or [])))
    rt.start()
    h = rt.get_input_handler("StockStream")

    def send(lo, hi):
        h.send_columns(data["ts"][lo:hi], {k: data[k][lo:hi] for k in cols}, now=0)

    send(0, 2 * b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        send(2 * b, 10 * b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = 0.0
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        busy_us += e.self_cuda_time_total if dev_us is None else dev_us
    rt.shutdown()
    mgr.shutdown()
    return wall * 1e3, busy_us / 1e3


def pattern_path_phase(torch, label: str, app: str, n_events: int, per_step: dict) -> dict:
    """One pattern path at full width (B=32768): `n_events` events of seed 7
    through send_columns in calls of 8 batches (the first of 4), fused;
    launch counts of this run alone, each of the path's kernels held to its
    launches per micro-batch step (per_step) times the steps run; no pattern
    overflow; the first 4 batches against device="cpu" and the first 20
    exactly against the per-batch form; matches per batch, events/s and the
    device busy share of one more fused call."""
    from siddhi_tpu_torch import kernels

    b = MAIN_BATCH
    data = stock_data(n_events, seed=7)
    first_n, stride = 4 * b, 8 * b
    prefix_calls, prefix_events = 3, 20 * b
    run_app("cuda", app, data, 4 * b, 2 * b, 2 * b)  # warm-up, not counted
    kernels.launches.clear()
    (n_rows, kept, dt, info), warned = capture_warnings(
        lambda: run_app("cuda", app, data, n_events, stride, first_n, keep_calls=prefix_calls),
        "patternCapacity")
    launches = dict(kernels.launches)
    print(f"{label} launches {json.dumps(launches)}", flush=True)
    if warned:
        raise AssertionError(f"{label}: the pattern token table or emission buffer overflowed")
    calls = [first_n] + [stride] * ((n_events - first_n) // stride)
    if n_events - sum(calls):
        calls.append(n_events - sum(calls))
    # micro-batch steps: the fused engine's (its short tail variant's empty
    # micro-batches included) and the per-batch path's for calls under 2 B
    steps = info["batches"] + sum(-(-c // b) for c in calls if c < 2 * b)
    for k, per in per_step.items():
        if launches.get(k, 0) != per * steps:
            raise AssertionError(f"{label}: {launches.get(k, 0)} launches of {k}, expected "
                                 f"{per} a step x {steps} steps")
    _n, cpu_first, _dt, _i = run_app("cpu", app, data, first_n, first_n, first_n)
    check_path(label, launches, tuple(per_step) + ("wire_decode", "deliver_pack"), kept,
               cpu_first, 1)
    pb_rows, pb_kept, pb_dt, _i = run_app("cuda", app, data, prefix_events, stride, first_n,
                                          fused=False, keep_calls=prefix_calls)
    fused_prefix = [row for call in kept for row in call]
    pb_prefix = [row for call in pb_kept for row in call]
    if not pb_prefix or fused_prefix != pb_prefix:
        raise AssertionError(f"{label}: fused rows differ from the per-batch form")
    wall_ms, busy_ms = fused_busy(torch, app, data, b)
    n_batches = -(-n_events // b)
    out = {"events": n_events, "rows": n_rows, "seconds": dt, "events_per_s": n_events / dt,
           "chunks": info["chunks"], "batches": info["batches"], "steps": steps,
           "wire": info["wire"], "launches": launches, "matches_per_batch": n_rows / n_batches,
           "busy": {"wall_ms_8_batches": wall_ms, "device_busy_ms": busy_ms,
                    "share": busy_ms / wall_ms},
           "per_batch": {"events": prefix_events, "rows": pb_rows, "seconds": pb_dt,
                         "events_per_s": prefix_events / pb_dt, "rows_exactly_equal": True}}
    print(f"path {label}: fused {n_events} events, {n_rows} rows delivered "
          f"({n_rows / n_batches:.1f} matches per batch), {dt:.3f} s, {n_events / dt:.1f} "
          f"events/s, {info['chunks']} chunks, {steps} steps; per-batch form {prefix_events} "
          f"events, {pb_rows} rows, {pb_dt:.3f} s, {prefix_events / pb_dt:.1f} events/s; no "
          f"overflow; first 4 batches match device='cpu', first 20 batches exactly equal the "
          f"per-batch form; device busy {busy_ms:.3f} of {wall_ms:.3f} ms over one fused call "
          f"of 8 batches ({busy_ms / wall_ms:.4f})", flush=True)
    return out


def cpu_check(label: str, app: str, data: dict, stride: int = SCAN_CPU_EVENTS,
              cols=("symbol", "price", "volume"), symbols=SYMBOLS, n=SCAN_CPU_EVENTS) -> dict:
    """The first n (SCAN_CPU_EVENTS) events of `app`, in calls of `stride`
    events, on the card and on device="cpu" (the plain versions): the same
    rows; prints the plain run's time."""
    calls = -(-n // stride)
    _n, gpu_kept, gpu_dt, _i = run_app("cuda", app, data, n, stride, stride, fused=False,
                                       keep_calls=calls, cols=cols, symbols=symbols)
    _n, cpu_kept, cpu_dt, _i = run_app("cpu", app, data, n, stride, stride, fused=False,
                                       keep_calls=calls, cols=cols, symbols=symbols)
    got = [r for c in gpu_kept for r in c]
    want = [r for c in cpu_kept for r in c]
    if not want or not rows_match(got, want):
        raise AssertionError(f"{label}: the first {n} events' rows differ from device='cpu'")
    print(f"{label}: the first {n} events' {len(want)} rows match device='cpu' ({gpu_dt:.3f} s "
          f"on the card, {cpu_dt:.3f} s for the plain versions on the host)", flush=True)
    return {"events": n, "rows": len(want), "card_s": gpu_dt, "cpu_plain_s": cpu_dt}


def logical_path_phase(torch) -> dict:
    """Path L: every (e1[price > 95] and e2[volume > 990]) -> e3[symbol ==
    e1.symbol and price < e1.price - 90] within 1 sec at @app:batch 32768,
    patternCapacity 1024: 1,000,000 events of seed 7 through send_columns in
    calls of 8 batches (the first of 4), fused (no scheduler), one K16
    launch per step (counts of this run alone), the fused path's kernels
    launched, no pattern overflow; the first 20 batches exactly against the
    per-batch form and the first 8,192 events against device="cpu"; matches
    per batch, events/s and the device busy share of one more fused call."""
    from siddhi_tpu_torch import kernels

    b = MAIN_BATCH
    app = LOGICAL_APP.format(batch=b)
    data = stock_data(LOGICAL_EVENTS, seed=7)
    first_n, stride = 4 * b, 8 * b
    prefix_calls, prefix_events = 3, 20 * b
    run_app("cuda", app, data, 4 * b, 2 * b, 2 * b)  # warm-up, not counted
    kernels.launches.clear()
    (n_rows, kept, dt, info), warned = capture_warnings(
        lambda: run_app("cuda", app, data, LOGICAL_EVENTS, stride, first_n,
                        keep_calls=prefix_calls), "patternCapacity")
    launches = dict(kernels.launches)
    print(f"L logical_pattern launches {json.dumps(launches)}", flush=True)
    if warned:
        raise AssertionError("path L: the pattern token table or emission buffer overflowed")
    calls = [first_n] + [stride] * ((LOGICAL_EVENTS - first_n) // stride)
    if LOGICAL_EVENTS - sum(calls):
        calls.append(LOGICAL_EVENTS - sum(calls))
    steps = info["batches"] + sum(-(-c // b) for c in calls if c < 2 * b)
    if launches.get("pattern_scan", 0) != steps:
        raise AssertionError(f"path L: {launches.get('pattern_scan', 0)} K16 launches for "
                             f"{steps} steps")
    for k in ("wire_decode", "deliver_pack"):
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} was not launched on path L")
    pb_rows, pb_kept, pb_dt, _i = run_app("cuda", app, data, prefix_events, stride, first_n,
                                          fused=False, keep_calls=prefix_calls)
    fused_prefix = [row for call in kept for row in call]
    pb_prefix = [row for call in pb_kept for row in call]
    if not pb_prefix or fused_prefix != pb_prefix:
        raise AssertionError("path L: fused rows differ from the per-batch form")
    cpu = cpu_check("path L", app, data)
    wall_ms, busy_ms = fused_busy(torch, app, data, b)
    n_batches = -(-LOGICAL_EVENTS // b)
    out = {"events": LOGICAL_EVENTS, "rows": n_rows, "seconds": dt,
           "events_per_s": LOGICAL_EVENTS / dt, "chunks": info["chunks"],
           "batches": info["batches"], "steps": steps, "launches": launches,
           "matches_per_batch": n_rows / n_batches,
           "busy": {"wall_ms_8_batches": wall_ms, "device_busy_ms": busy_ms,
                    "share": busy_ms / wall_ms},
           "per_batch": {"events": prefix_events, "rows": pb_rows, "seconds": pb_dt,
                         "events_per_s": prefix_events / pb_dt, "rows_exactly_equal": True},
           "cpu_check": cpu}
    print(f"path L logical_pattern: fused {LOGICAL_EVENTS} events, {n_rows} rows delivered "
          f"({n_rows / n_batches:.1f} matches per batch), {dt:.3f} s, {LOGICAL_EVENTS / dt:.1f} "
          f"events/s, {steps} steps = K16 launches; per-batch form {prefix_events} events, "
          f"{pb_rows} rows, {pb_dt:.3f} s, {prefix_events / pb_dt:.1f} events/s; no overflow; "
          f"first 20 batches exactly equal the per-batch form; device busy {busy_ms:.3f} of "
          f"{wall_ms:.3f} ms over one fused call of 8 batches ({busy_ms / wall_ms:.4f})",
          flush=True)
    return out


def absent_path_phase(torch) -> dict:
    """Path A: every e1[price > 95] -> not [symbol == e1.symbol and price <
    5] for 100 milliseconds under @app:playback at @app:batch 32768,
    patternCapacity 1024: 16 batches of seed 7, one per call (a pattern that
    needs the scheduler stays off the fused path), with the one-row TIMER
    steps the event-time clock sends counted; K16 launches = data steps +
    TIMER steps (counts of this run alone); no pattern overflow; the first
    8,192 events against device="cpu"."""
    from siddhi_tpu_torch import kernels

    b = MAIN_BATCH
    n = ABSENT_BATCHES * b
    app = ABSENT_APP.format(batch=b)
    data = stock_data(n, seed=7)
    run_app("cuda", app, data, 2 * b, b, b, fused=False)  # warm-up, not counted
    fires = [0]
    kernels.launches.clear()
    (n_rows, _kept, dt, _info), warned = capture_warnings(
        lambda: run_app("cuda", app, data, n, b, b, fused=False, fires=fires),
        "patternCapacity")
    launches = dict(kernels.launches)
    print(f"A absent_pattern launches {json.dumps(launches)}", flush=True)
    if warned:
        raise AssertionError("path A: the pattern token table or emission buffer overflowed")
    if launches.get("pattern_scan", 0) != ABSENT_BATCHES + fires[0]:
        raise AssertionError(f"path A: {launches.get('pattern_scan', 0)} K16 launches for "
                             f"{ABSENT_BATCHES} data steps and {fires[0]} TIMER steps")
    cpu = cpu_check("path A", app, data)
    out = {"events": n, "rows": n_rows, "seconds": dt, "events_per_s": n / dt,
           "data_steps": ABSENT_BATCHES, "timer_steps": fires[0], "launches": launches,
           "matches_per_batch": n_rows / ABSENT_BATCHES, "cpu_check": cpu}
    print(f"path A absent_pattern: {n} events in {ABSENT_BATCHES} batches and {fires[0]} one-row "
          f"TIMER steps (= K16 launches {launches.get('pattern_scan', 0)} - {ABSENT_BATCHES}), "
          f"{n_rows} rows delivered ({n_rows / ABSENT_BATCHES:.1f} matches per batch), {dt:.3f} "
          f"s, {n / dt:.1f} events/s; no overflow", flush=True)
    return out


def tb_path_phase(torch) -> dict:
    """Path TB: BASELINE.json config 2 as a tumbling time window (timeBatch(1
    sec) group by symbol with avg, stdDev, min, max, maxForever,
    distinctCount and count) under @app:playback at @app:batch 32768, 8
    batches of seed-7 1 ms ticks sent one 1-second bucket (1,000 events) a
    call: a playback send advances the event-time clock to its last
    timestamp before its rows are processed, so each call's TIMER step (the
    open bucket's end) closes the previous call's bucket, and a longer call
    would fire its buckets' TIMER steps first and pile its rows into one
    bucket past the w=1024 slots. Per batch only (the scheduler keeps it off
    the fused path); launch counts of this run alone; K17 launches = data
    steps + TIMER steps; no group overflow; every closed bucket's count sums
    to the events sent before the open one; the first 8,192 events against
    device="cpu" at @app:batch 4096."""
    from siddhi_tpu_torch import kernels

    b, bucket = TB_BATCH, 1000
    n = TB_BATCHES * b
    app_of = lambda batch: TB_APP.format(batch=batch)  # noqa: E731
    data = stock_data(n, seed=7)
    cols = ("symbol", "price", "volume")
    run_app("cuda", app_of(b), data, 4 * bucket, bucket, bucket, fused=False, cols=cols)  # warm-up
    fires = [0]
    calls = -(-n // bucket)
    kernels.launches.clear()
    (n_rows, kept, dt, _info), warned = capture_warnings(
        lambda: run_app("cuda", app_of(b), data, n, bucket, bucket, fused=False, fires=fires,
                        keep_calls=calls, cols=cols), "groupCapacity")
    launches = dict(kernels.launches)
    print(f"TB time_batch launches {json.dumps(launches)}", flush=True)
    if warned:
        raise AssertionError("path TB: the group-by slot table overflowed")
    for k in TB_KERNELS:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} was not launched on path TB")
    if launches["time_batch_step"] != calls + fires[0]:
        raise AssertionError(f"path TB: {launches['time_batch_step']} K17 launches for {calls} "
                             f"data steps and {fires[0]} TIMER steps")
    rows = [r for c in kept for r in c]
    counted = sum(r[-1] for r in rows)
    if counted != n - (n % bucket or bucket):
        raise AssertionError(f"path TB: the closed buckets count {counted} events")
    # at @app:batch TB_CHECK_BATCH: the plain K3 and K20 are O(rows x
    # elements) on the host
    cpu = cpu_check("path TB", app_of(TB_CHECK_BATCH), data, bucket, cols)
    out = {"events": n, "rows": n_rows, "seconds": dt, "events_per_s": n / dt,
           "data_steps": calls, "timer_steps": fires[0], "buckets_closed": n_rows / len(SYMBOLS),
           "flushes_per_batch": fires[0] / TB_BATCHES, "events_counted": counted,
           "launches": launches, "cpu_check": cpu}
    print(f"path TB time_batch: {n} events in {calls} calls (one bucket each) and {fires[0]} "
          f"one-row TIMER steps, {n_rows} rows delivered ({fires[0] / TB_BATCHES:.1f} flushes "
          f"per 32768 events), closed buckets count {counted} events, {dt:.3f} s, "
          f"{n / dt:.1f} events/s; no overflow", flush=True)
    return out


def xb_path_phase(torch) -> dict:
    """Path XB: externalTimeBatch(ets, 1 sec), ungrouped, with avg, stdDev,
    max, minForever, distinctCount(symbol) and count at @app:batch 32768:
    1,000,000 events of seed 7 (ets = the 1 ms tick timestamp) through
    send_columns in calls of 8 batches (the first of 4), fused (no
    scheduler); launch counts of this run alone; the first 20 batches
    exactly against the per-batch form and the first 8,192 events against
    device="cpu" at @app:batch 4096; flushes per batch (one row each),
    events/s and the device busy share of one more fused call."""
    from siddhi_tpu_torch import kernels

    b = TB_BATCH
    app_of = lambda batch: XB_APP.format(batch=batch)  # noqa: E731
    data = stock_data(XB_EVENTS, seed=7)
    data["ets"] = data["ts"].copy()
    cols = ("symbol", "price", "volume", "ets")
    first_n, stride = 4 * b, 8 * b
    prefix_calls, prefix_events = 3, 20 * b
    run_app("cuda", app_of(b), data, 4 * b, 2 * b, 2 * b, cols=cols)  # warm-up, not counted
    kernels.launches.clear()
    n_rows, kept, dt, info = run_app("cuda", app_of(b), data, XB_EVENTS, stride, first_n,
                                     keep_calls=prefix_calls, cols=cols)
    launches = dict(kernels.launches)
    print(f"XB external_time_batch launches {json.dumps(launches)}", flush=True)
    for k in XB_KERNELS:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} was not launched on path XB")
    pb_rows, pb_kept, pb_dt, _i = run_app("cuda", app_of(b), data, prefix_events, stride,
                                          first_n, fused=False, keep_calls=prefix_calls,
                                          cols=cols)
    fused_prefix = [row for call in kept for row in call]
    pb_prefix = [row for call in pb_kept for row in call]
    if not pb_prefix or fused_prefix != pb_prefix:
        raise AssertionError("path XB: fused rows differ from the per-batch form")
    cpu = cpu_check("path XB", app_of(TB_CHECK_BATCH), data, 2 * TB_CHECK_BATCH, cols)
    wall_ms, busy_ms = fused_busy(torch, app_of(b), data, b, cols)
    n_batches = -(-XB_EVENTS // b)
    out = {"events": XB_EVENTS, "rows": n_rows, "seconds": dt,
           "events_per_s": XB_EVENTS / dt, "chunks": info["chunks"],
           "batches": info["batches"], "flushes_per_batch": n_rows / n_batches,
           "launches": launches,
           "busy": {"wall_ms_8_batches": wall_ms, "device_busy_ms": busy_ms,
                    "share": busy_ms / wall_ms},
           "per_batch": {"events": prefix_events, "rows": pb_rows, "seconds": pb_dt,
                         "events_per_s": prefix_events / pb_dt, "rows_exactly_equal": True},
           "cpu_check": cpu}
    print(f"path XB external_time_batch: fused {XB_EVENTS} events, {n_rows} rows delivered "
          f"({n_rows / n_batches:.1f} flushes per batch), {dt:.3f} s, {XB_EVENTS / dt:.1f} "
          f"events/s; per-batch form {prefix_events} events, {pb_rows} rows, {pb_dt:.3f} s, "
          f"{prefix_events / pb_dt:.1f} events/s; first 20 batches exactly equal the per-batch "
          f"form; device busy {busy_ms:.3f} of {wall_ms:.3f} ms over one fused call of 8 "
          f"batches ({busy_ms / wall_ms:.4f})", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 11: the special-window, stream-function and rate-limit paths
# ---------------------------------------------------------------------------

SPECIAL_KERNEL_OF = {"SW": "sort_window_step", "FQ": "frequent_window_step",
                     "LF": "lossy_frequent_window_step", "CR": "cron_window_step"}
FQ_NAMES = [f"S{i}" for i in range(1, FQ_SYMBOLS + 1)]


def call_sizes(n: int, first: int, stride: int) -> list:
    sizes, sent = [], 0
    while sent < n:
        sizes.append(min(first if sent == 0 else stride, n - sent))
        sent += sizes[-1]
    return sizes


def special_path_phase(torch, label: str) -> dict:
    """Path SW, FQ or LF at @app:batch 32768 (SPECIAL_APPS): 1,000,000 events
    of seed 7 (FQ and LF: symbols over 1,000 names drawn from a Zipf law with
    exponent 1.2) through send_columns in calls of 8 batches (the first of
    4), fused; launch counts of this run alone: the window's kernel once a
    fused step; no window overflow logged; the first 20 batches exactly
    against the per-batch form and the first 8,192 events against
    device="cpu"; events/s and the device busy share of one more fused
    call."""
    from siddhi_tpu_torch import kernels

    b, kernel = SPECIAL_BATCH, SPECIAL_KERNEL_OF[label]
    app = SPECIAL_APPS[label].format(batch=b)
    n = {"SW": SW_EVENTS, "FQ": FQ_EVENTS, "LF": LF_EVENTS}[label]
    data = stock_data(n, seed=7)
    names = SYMBOLS
    if label in ("FQ", "LF"):
        data["symbol"], names = zipf_symbols(n), FQ_NAMES
    first_n, stride = 4 * b, 8 * b
    run_app("cuda", app, data, 4 * b, 2 * b, 2 * b, symbols=names)  # warm-up, not counted
    kernels.launches.clear()
    (n_rows, kept, dt, info), warned = capture_warnings(
        lambda: run_app("cuda", app, data, n, stride, first_n, keep_calls=3, symbols=names),
        "window emission")
    launches = dict(kernels.launches)
    print(f"{label} launches {json.dumps(launches)}", flush=True)
    if warned:
        raise AssertionError(f"path {label}: the window's buffer overflowed")
    steps = sum(fused_steps(c, b) for c in call_sizes(n, first_n, stride))
    if launches.get(kernel, 0) != steps:
        raise AssertionError(f"path {label}: {launches.get(kernel, 0)} {kernel} launches for "
                             f"{steps} steps")
    pb_rows, pb_kept, pb_dt, _i = run_app("cuda", app, data, 20 * b, stride, first_n,
                                          fused=False, keep_calls=3, symbols=names)
    fused_prefix = [row for call in kept for row in call]
    pb_prefix = [row for call in pb_kept for row in call]
    if not pb_prefix or fused_prefix != pb_prefix:
        raise AssertionError(f"path {label}: fused rows differ from the per-batch form")
    cpu = cpu_check(f"path {label}", app, data, SCAN_CPU_EVENTS, symbols=names)
    wall_ms, busy_ms = fused_busy(torch, app, data, b, symbols=names)
    out = {"events": n, "rows": n_rows, "seconds": dt, "events_per_s": n / dt,
           "steps": steps, "launches": launches, "chunks": info["chunks"],
           "busy": {"wall_ms_8_batches": wall_ms, "device_busy_ms": busy_ms,
                    "share": busy_ms / wall_ms},
           "per_batch": {"events": 20 * b, "rows": pb_rows, "seconds": pb_dt,
                         "events_per_s": 20 * b / pb_dt, "rows_exactly_equal": True},
           "cpu_check": cpu}
    print(f"path {label}: fused {n} events, {n_rows} rows delivered, {dt:.3f} s, "
          f"{n / dt:.1f} events/s, {steps} steps = {kernel} launches; per-batch form "
          f"{20 * b} events, {pb_dt:.3f} s, {20 * b / pb_dt:.1f} events/s, first 20 batches "
          f"exactly equal; device busy {busy_ms:.3f} of {wall_ms:.3f} ms over one fused call "
          f"of 8 batches ({busy_ms / wall_ms:.4f}); no overflow", flush=True)
    return out


def cron_path_phase(torch) -> dict:
    """Path CR: cron('*/1 * * * * ?') group by symbol with sum and count
    under @app:playback at @app:batch 32768: 16 calls of one 1,000-event
    bucket of seed-7 1 ms ticks each; each call's event-time advance fires
    the cron TIMER step that closes the previous bucket. Per batch (the
    scheduler keeps it off the fused path); K28 launches = data steps +
    TIMER steps; no overflow; the closed buckets' counts sum to their
    events; the first 8,192 events against device="cpu"."""
    from siddhi_tpu_torch import kernels

    b, n = SPECIAL_BATCH, CR_CALLS * CR_BUCKET
    app = SPECIAL_APPS["CR"].format(batch=b)
    data = stock_data(n, seed=7)
    run_app("cuda", app, data, 4 * CR_BUCKET, CR_BUCKET, CR_BUCKET, fused=False)  # warm-up
    fires = [0]
    kernels.launches.clear()
    (n_rows, kept, dt, _info), warned = capture_warnings(
        lambda: run_app("cuda", app, data, n, CR_BUCKET, CR_BUCKET, fused=False, fires=fires,
                        keep_calls=CR_CALLS), "window emission")
    launches = dict(kernels.launches)
    print(f"CR launches {json.dumps(launches)}", flush=True)
    if warned:
        raise AssertionError("path CR: the cron bucket overflowed")
    data_steps = sum(-(-c // b) for c in call_sizes(n, CR_BUCKET, CR_BUCKET))
    if launches.get("cron_window_step", 0) != data_steps + fires[0]:
        raise AssertionError(f"path CR: {launches.get('cron_window_step', 0)} K28 launches for "
                             f"{data_steps} data steps and {fires[0]} TIMER steps")
    counted = sum(r[-1] for c in kept for r in c)
    if counted != n - CR_BUCKET:
        raise AssertionError(f"path CR: the closed buckets count {counted} events")
    cpu = cpu_check("path CR", app, data, CR_BUCKET)
    out = {"events": n, "rows": n_rows, "seconds": dt, "events_per_s": n / dt,
           "data_steps": data_steps, "timer_steps": fires[0], "events_counted": counted,
           "launches": launches, "cpu_check": cpu}
    print(f"path CR: {n} events in {CR_CALLS} calls (one bucket each) and {fires[0]} TIMER "
          f"steps, {n_rows} rows delivered, closed buckets count {counted} events, {dt:.3f} s, "
          f"{n / dt:.1f} events/s; no overflow", flush=True)
    return out


def fn_path_phase(torch) -> dict:
    """Path FN: #pol2Cart(price, volume), a filter on the added x, and
    `output last every 4096 events` at @app:batch 32768: 1,000,000 events of
    seed 7 through send_columns in calls of 8 batches, per batch (the
    limiter keeps the junction off the fused path); one row per 4,096
    passing events; the first 8,192 events against device="cpu"; events/s
    and the device busy share of one call of 8 batches."""
    from torch.profiler import ProfilerActivity, profile

    from siddhi_tpu_torch import SiddhiManager

    b = SPECIAL_BATCH
    app = SPECIAL_APPS["FN"].format(batch=b, every=FN_EVERY)
    data = stock_data(FN_EVENTS, seed=7)
    run_app("cuda", app, data, 2 * b, 2 * b, 2 * b, fused=False)  # warm-up
    n_rows, _kept, dt, _info = run_app("cuda", app, data, FN_EVENTS, 8 * b, 8 * b, fused=False)
    # the stream function's own arithmetic, on the card
    price = torch.from_numpy(data["price"]).cuda()
    x = torch.from_numpy(data["volume"]).cuda().float() * torch.cos(torch.deg2rad(price))
    passing = int((x > 0).sum())
    if n_rows != passing // FN_EVERY:
        raise AssertionError(f"path FN: {n_rows} rows for {passing} passing events")
    cpu = cpu_check("path FN", app.replace(f"every {FN_EVERY} events", "every 16 events"),
                    data, SCAN_CPU_EVENTS)
    mgr = SiddhiManager()
    rt = mgr.create_siddhi_app_runtime(app)
    for s_ in SYMBOLS:
        mgr.interner.intern(s_)
    rt.start()
    h = rt.get_input_handler("StockStream")
    cols = ("symbol", "price", "volume")
    h.send_columns(data["ts"][:b], {k: data[k][:b] for k in cols}, now=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        h.send_columns(data["ts"][b:9 * b], {k: data[k][b:9 * b] for k in cols}, now=0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us = 0.0
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        busy_us += e.self_cuda_time_total if dev_us is None else dev_us
    busy_ms = busy_us / 1e3
    rt.shutdown()
    mgr.shutdown()
    out = {"events": FN_EVENTS, "rows": n_rows, "passing": passing, "seconds": dt,
           "events_per_s": FN_EVENTS / dt,
           "busy": {"wall_ms_8_batches": wall_ms, "device_busy_ms": busy_ms,
                    "share": busy_ms / wall_ms}, "cpu_check": cpu}
    print(f"path FN: {FN_EVENTS} events per batch, {passing} pass the filter, {n_rows} rows "
          f"(one per {FN_EVERY}), {dt:.3f} s, {FN_EVENTS / dt:.1f} events/s; device busy "
          f"{busy_ms:.3f} of {wall_ms:.3f} ms over one call of 8 batches "
          f"({busy_ms / wall_ms:.4f})", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 12: path PT, a partitioned length window feeding an inner stream
# ---------------------------------------------------------------------------

# K29, K30 and K7 once a step; K8 three times (avg's sum and count, count)
PT_KERNELS = {"partition_length_window_step": 1, "partition_window_extreme": 1,
              "assign_slots": 1, "keyed_running_sum": 3}


def call_breakdown(torch, app: str, data: dict, b: int, symbols,
                   cols=("symbol", "price", "volume")) -> dict:
    """Where one call of 8 batches goes (after a warm-up call of 2):
    device time by kernel from torch.profiler, then host time by function
    from cProfile over another call of 8."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    from siddhi_tpu_torch import SiddhiManager

    mgr = SiddhiManager()
    rt = mgr.create_siddhi_app_runtime(app)
    for s in symbols:
        mgr.interner.intern(s)
    rt.add_callback("q", lambda t, ins, rem: None)
    rt.start()
    h = rt.get_input_handler("StockStream")

    def send(lo, hi):
        h.send_columns(data["ts"][lo:hi], {k: data[k][lo:hi] for k in cols}, now=0)
        torch.cuda.synchronize()

    send(0, 2 * b)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        send(2 * b, 10 * b)
    by_kernel = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        dev_us = e.self_cuda_time_total if dev_us is None else dev_us
        if dev_us > 0:
            by_kernel.append((e.key[:80], e.count, dev_us / 1e3))
    by_kernel.sort(key=lambda k: -k[2])
    host = cProfile.Profile()
    host.enable()
    t0 = time.perf_counter()
    send(10 * b, 18 * b)
    wall = time.perf_counter() - t0
    host.disable()
    top = sorted(pstats.Stats(host).stats.items(), key=lambda kv: -kv[1][2])[:12]
    by_func = [(f"{os.path.basename(f)}:{ln}({fn})", st[1], st[2] * 1e3)
               for (f, ln, fn), st in top]
    rt.shutdown()
    mgr.shutdown()
    for name, count, ms in by_kernel[:10]:
        print(f"breakdown: device {ms:9.3f} ms x{count:<5d} {name}", flush=True)
    print(f"breakdown: host, one call of 8 batches under cProfile: {wall * 1e3:.3f} ms",
          flush=True)
    for where, n, ms in by_func:
        print(f"breakdown: host {ms:9.3f} ms own x{n:<7d} {where}", flush=True)
    return {"device_by_kernel": by_kernel[:20], "host_call_ms": wall * 1e3,
            "host_by_function": by_func}


def partition_path_phase(torch) -> dict:
    """Path PT (PT_APP): `partition with (symbol of StockStream)`, a
    length(50) window per key with avg, max and count into `#A`, a filter on
    `#A` into Out, @app:batch 32768, @app:partitionCapacity 1024, over
    1,000,000 events of seed 7 whose symbols are 1,000 names drawn
    uniformly, through send_columns in calls of 8 batches (the first of 4);
    a partitioned stream runs per batch. Launch counts of this run alone,
    each held to its uses a step times the steps (K19 is not on this path:
    PT's max is windowed, K30); events/s and the device busy share of one
    more call of 8 batches; the first 4 batches against device="cpu"; then
    the same app at partitionCapacity 512 over 8,192 events (about 1,000
    keys: the table overflows, the overflow is logged once, the keys past
    capacity deliver nothing) against device="cpu"."""
    from siddhi_tpu_torch import kernels

    b = MAIN_BATCH
    names = [f"SYM{i:04d}" for i in range(PT_SYMBOLS)]
    data = stock_data(PT_EVENTS, seed=7)
    data["symbol"] = np.random.default_rng(7).integers(
        1, PT_SYMBOLS + 1, size=PT_EVENTS).astype(np.int32)
    app = PT_APP.format(batch=b, cap=PT_CAP, w=PT_W)
    first_n, stride = 4 * b, 8 * b
    run_app("cuda", app, data, 2 * b, b, b, fused=False, symbols=names)  # warm-up
    kernels.launches.clear()
    n_rows, kept, dt, _i = run_app("cuda", app, data, PT_EVENTS, stride, first_n, fused=False,
                                   symbols=names)
    launches = dict(kernels.launches)
    steps = sum(-(-c // b) for c in call_sizes(PT_EVENTS, first_n, stride))
    print(f"path PT launches {json.dumps(launches)} over {steps} steps", flush=True)
    for k, uses in PT_KERNELS.items():
        if launches.get(k, 0) != uses * steps:
            raise AssertionError(f"path PT: kernel {k} launched {launches.get(k, 0)} times, "
                                 f"expected {uses} x {steps} steps")
    _n, cpu_first, _dt, _i = run_app("cpu", app, data, first_n, first_n, first_n, fused=False,
                                     symbols=names)
    check_path("PT", launches, PT_KERNELS, kept, cpu_first, 1)
    wall_ms, busy_ms = fused_busy(torch, app, data, b, symbols=names)
    out = {"events": PT_EVENTS, "rows": n_rows, "seconds": dt, "events_per_s": PT_EVENTS / dt,
           "steps": steps, "launches": launches, "busy_call_wall_ms": wall_ms,
           "busy_call_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
           "breakdown": call_breakdown(torch, app, data, b, names)}
    print(f"path PT partitioned length window: {PT_EVENTS} events per batch, {n_rows} rows "
          f"delivered, {dt:.3f} s, {PT_EVENTS / dt:.1f} events/s; one call of 8 batches: "
          f"wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.4f}); "
          "first 4 batches match device='cpu'", flush=True)

    # an overflowing key table: 1,000 keys into 512 slots
    n = 8192
    small = PT_APP.format(batch=b, cap=PT_CAP // 2, w=PT_W)
    (_n, ov_cuda, _dt, _i), warns = capture_warnings(
        lambda: run_app("cuda", small, data, n, n, n, fused=False, symbols=names),
        needle="partitionCapacity")
    _n, ov_cpu, _dt, _i = run_app("cpu", small, data, n, n, n, fused=False, symbols=names)
    seen = list(dict.fromkeys(data["symbol"][:n].tolist()))
    kept_names = {names[s - 1] for s in seen[:PT_CAP // 2]}
    delivered = {r[0] for r in ov_cuda[0]}
    if len(seen) <= PT_CAP // 2 or len(warns) != 1 or not ov_cpu[0] or not rows_match(
            ov_cuda[0], ov_cpu[0]) or not delivered <= kept_names:
        raise AssertionError(f"path PT at partitionCapacity {PT_CAP // 2}: {len(seen)} keys, "
                             f"{len(warns)} overflow logs, rows equal to device='cpu': "
                             f"{rows_match(ov_cuda[0], ov_cpu[0])}, only kept keys delivered: "
                             f"{delivered <= kept_names}")
    out["capacity_512_overflow"] = {"events": n, "keys": len(seen), "rows": len(ov_cuda[0]),
                                    "overflow_logs": len(warns)}
    print(f"path PT at partitionCapacity {PT_CAP // 2}: {len(seen)} keys in {n} events, "
          f"{len(ov_cuda[0])} rows match device='cpu', overflow logged once, keys past "
          "capacity deliver nothing", flush=True)
    return out


PTE_KERNELS = {"assign_slots": 1, "partition_time_window_step": 1, "partition_rows": 1,
               "partition_window_extreme": 1, "keyed_running_sum": 3}
PTB_KERNELS = {"assign_slots": 1, "partition_batch_window_step": 1,
               "partition_assign_slots": 1, "keyed_running_sum": 4, "keep_last": 1}
# PTT sends 4,096 events, its first call of 640 against device="cpu"
# (8,192 and 1,280 until the partitioned joins joined the script's time)
PTB_CAP, PTT_EVENTS, PTT_FIRST, PTT_CALL = 32, 2688, 640, 2048
PTW_COLS = ("symbol", "price", "volume", "ets")


def ptw_data(n: int) -> tuple:
    """Seed-7 stock rows of 1 ms ticks, `ets` the tick, symbols 1,000 names
    drawn uniformly."""
    names = [f"SYM{i:04d}" for i in range(PT_SYMBOLS)]
    data = stock_data(n, seed=7)
    data["symbol"] = np.random.default_rng(7).integers(1, PT_SYMBOLS + 1, size=n).astype(np.int32)
    data["ets"] = data["ts"].copy()
    return data, names


def calls_busy(torch, app: str, data: dict, size: int, warm: int, calls: int, cols,
               symbols) -> tuple:
    """Device busy share of `calls` send_columns calls of `size` events
    (their TIMER steps included) after `warm` such calls, from
    torch.profiler: (wall ms, device busy ms)."""
    from torch.profiler import ProfilerActivity, profile

    from siddhi_tpu_torch import SiddhiManager

    mgr = SiddhiManager()
    rt = mgr.create_siddhi_app_runtime(app)
    for s in symbols:
        mgr.interner.intern(s)
    rt.add_callback("q", lambda t, ins, rem: None)
    rt.start()
    h = rt.get_input_handler("StockStream")

    def send(c):
        lo, hi = c * size, (c + 1) * size
        h.send_columns(data["ts"][lo:hi], {k: data[k][lo:hi] for k in cols}, now=0)

    for c in range(warm):
        send(c)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for c in range(warm, warm + calls):
            send(c)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = 0.0
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        busy_us += e.self_cuda_time_total if dev_us is None else dev_us
    rt.shutdown()
    mgr.shutdown()
    return wall * 1e3, busy_us / 1e3


def held_launches(label: str, launches: dict, wanted: dict, steps: int) -> None:
    for k, uses in wanted.items():
        if launches.get(k, 0) != uses * steps:
            raise AssertionError(f"path {label}: kernel {k} launched {launches.get(k, 0)} times, "
                                 f"expected {uses} x {steps} steps")


def partition_windows_path_phase(torch) -> dict:
    """The time and batch windows inside a partition at full width.

    PTE (PTW_APPS): `partition with (symbol of StockStream)`, externalTime(
    ets, 60 sec) with avg, max and count per symbol, @app:batch 32768,
    @app:partitionCapacity 1024, 1,000,000 events of seed 7 (1 ms ticks, ets
    = ts, 1,000 symbols drawn uniformly) through send_columns in calls of 8
    batches (the first of 2), per batch; launches of this run alone, each
    held to its uses a step times the steps; events/s, the device busy
    share of one more call of 8 batches and where a call's time goes
    (`call_breakdown`); the first 2 batches against device="cpu".

    PTB: three price bands as a range partition, timeBatch(1 sec) group by
    symbol with avg, sum and count, @app:groupCapacity 1024, @app:playback,
    4 batches' worth of the same traffic sent one 1-second bucket (1,000
    events) a call, each call's TIMER step (every band's bucket end)
    closing the previous bucket; launches held per step (data and TIMER);
    no group overflow; the closed buckets count every event sent before the
    open one; the device busy share of 8 more calls; the first 8,192 events
    against device="cpu".

    PTT: PTE on time(1 sec) under @app:playback, 4,096 events in calls of
    2,048 (the first of 640): each call fires one TIMER step per distinct
    expiry time, and each reaches every partition; K31 launches = data
    steps + TIMER steps; the first call against device="cpu"; the device
    busy share of a second call."""
    from siddhi_tpu_torch import kernels

    out = {}
    b = MAIN_BATCH
    data, names = ptw_data(PT_EVENTS)
    # ---- PTE
    app = partition_window_app("PTE", b, PT_CAP)
    first_n, stride = 2 * b, 8 * b
    run_app("cuda", app, data, 2 * b, b, b, fused=False, symbols=names, cols=PTW_COLS)
    kernels.launches.clear()
    n_rows, kept, dt, _i = run_app("cuda", app, data, PT_EVENTS, stride, first_n, fused=False,
                                   symbols=names, cols=PTW_COLS)
    launches = dict(kernels.launches)
    steps = sum(-(-c // b) for c in call_sizes(PT_EVENTS, first_n, stride))
    print(f"path PTE launches {json.dumps(launches)} over {steps} steps", flush=True)
    held_launches("PTE", launches, PTE_KERNELS, steps)
    t0 = time.perf_counter()
    _n, cpu_first, _dt, _i = run_app("cpu", app, data, first_n, first_n, first_n, fused=False,
                                     symbols=names, cols=PTW_COLS)
    cpu_s = time.perf_counter() - t0
    check_path("PTE", launches, PTE_KERNELS, kept, cpu_first, 1)
    wall_ms, busy_ms = fused_busy(torch, app, data, b, cols=PTW_COLS, symbols=names)
    out["PTE"] = {"events": PT_EVENTS, "rows": n_rows, "seconds": dt,
                  "events_per_s": PT_EVENTS / dt, "steps": steps, "launches": launches,
                  "busy_call_wall_ms": wall_ms, "busy_call_busy_ms": busy_ms,
                  "busy_share": busy_ms / wall_ms, "cpu_check_s": cpu_s,
                  "breakdown": call_breakdown(torch, app, data, b, names, cols=PTW_COLS)}
    print(f"path PTE partitioned externalTime(60 sec): {PT_EVENTS} events per batch, {n_rows} "
          f"rows delivered, {dt:.3f} s, {PT_EVENTS / dt:.1f} events/s; one call of 8 batches: "
          f"wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.4f}); "
          f"first 2 batches match device='cpu' ({cpu_s:.1f} s on the host)", flush=True)

    # ---- PTB
    bucket = 1000
    n = TB_BATCHES * b
    app = partition_window_app("PTB", b, PTB_CAP)
    run_app("cuda", app, data, 4 * bucket, bucket, bucket, fused=False, symbols=names,
            cols=PTW_COLS)
    fires = [0]
    calls = -(-n // bucket)
    kernels.launches.clear()
    (n_rows, kept, dt, _i), warned = capture_warnings(
        lambda: run_app("cuda", app, data, n, bucket, bucket, fused=False, fires=fires,
                        keep_calls=calls, symbols=names, cols=PTW_COLS), "groupCapacity")
    launches = dict(kernels.launches)
    print(f"path PTB launches {json.dumps(launches)} over {calls} data and {fires[0]} TIMER "
          "steps", flush=True)
    if warned:
        raise AssertionError("path PTB: the group-by slot table overflowed")
    held_launches("PTB", launches, PTB_KERNELS, calls + fires[0])
    rows = [r for c in kept for r in c]
    counted = sum(r[-1] for r in rows)
    if counted != n - (n % bucket or bucket):
        raise AssertionError(f"path PTB: the closed buckets count {counted} events")
    cpu = cpu_check("path PTB", partition_window_app("PTB", TB_CHECK_BATCH, PTB_CAP), data,
                    bucket, PTW_COLS, symbols=names)
    wall_ms, busy_ms = calls_busy(torch, app, data, bucket, 2, 8, PTW_COLS, names)
    out["PTB"] = {"events": n, "rows": n_rows, "seconds": dt, "events_per_s": n / dt,
                  "data_steps": calls, "timer_steps": fires[0], "events_counted": counted,
                  "launches": launches, "cpu_check": cpu, "busy_8_calls_wall_ms": wall_ms,
                  "busy_8_calls_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms}
    print(f"path PTB banded timeBatch group by: {n} events in {calls} calls (one bucket each) "
          f"and {fires[0]} one-row TIMER steps, {n_rows} rows delivered, closed buckets count "
          f"{counted} events, {dt:.3f} s, {n / dt:.1f} events/s; no overflow; 8 calls: wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.4f})",
          flush=True)

    # ---- PTT
    app = partition_window_app("PTT", b, PT_CAP)
    run_app("cuda", app, data, PTT_FIRST, PTT_CALL, PTT_FIRST, fused=False, symbols=names,
            cols=PTW_COLS)
    fires = [0]
    calls = len(call_sizes(PTT_EVENTS, PTT_FIRST, PTT_CALL))
    kernels.launches.clear()
    n_rows, kept, dt, _i = run_app("cuda", app, data, PTT_EVENTS, PTT_CALL, PTT_FIRST,
                                   fused=False, fires=fires, symbols=names, cols=PTW_COLS)
    launches = dict(kernels.launches)
    print(f"path PTT launches {json.dumps(launches)} over {calls} data and {fires[0]} TIMER "
          "steps", flush=True)
    if fires[0] <= 0 or launches.get("partition_time_window_step", 0) != calls + fires[0]:
        raise AssertionError(f"path PTT: {fires[0]} TIMER steps, "
                             f"{launches.get('partition_time_window_step', 0)} K31 launches "
                             f"for {calls} data steps")
    held_launches("PTT", launches, PTE_KERNELS, calls + fires[0])
    t0 = time.perf_counter()
    _n, cpu_first, _dt, _i = run_app("cpu", app, data, PTT_FIRST, PTT_FIRST, PTT_FIRST,
                                     fused=False, symbols=names, cols=PTW_COLS)
    cpu_s = time.perf_counter() - t0
    check_path("PTT", launches, PTE_KERNELS, kept, cpu_first, 1)
    wall_ms, busy_ms = calls_busy(torch, app, data, PTT_FIRST, 1, 1, PTW_COLS, names)
    out["PTT"] = {"events": PTT_EVENTS, "rows": n_rows, "seconds": dt,
                  "events_per_s": PTT_EVENTS / dt, "data_steps": calls, "timer_steps": fires[0],
                  "launches": launches, "cpu_check_s": cpu_s, "busy_call_wall_ms": wall_ms,
                  "busy_call_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms}
    print(f"path PTT partitioned time(1 sec), playback: {PTT_EVENTS} events in {calls} calls and "
          f"{fires[0]} TIMER steps over every partition, {n_rows} rows delivered, {dt:.3f} s, "
          f"{PTT_EVENTS / dt:.1f} events/s; the first call matches device='cpu' "
          f"({cpu_s:.1f} s on the host); its second call: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.4f})", flush=True)
    return out


PPF_KERNELS = {"assign_slots": 1, "pattern_chunks": 1, "pattern_place": 1,
               "partition_pattern_advance": 2 * (MAIN_BATCH // (PP_T // 2)),
               "partition_pattern_emit": MAIN_BATCH // (PP_T // 2)}
PPC_KERNELS = {"assign_slots": 1, "pattern_chunks": 1, "pattern_place": 1,
               "partition_pattern_count": MAIN_BATCH // (2 * PP_T),
               "partition_pattern_emit": MAIN_BATCH // (2 * PP_T)}
PP_CPU_EVENTS, PPA_CPU_EVENTS = 2048, 512


def pp_data(n: int) -> tuple:
    """stock_data's 1 ms traffic with 1,000 symbols drawn uniformly."""
    names = [f"SYM{i:04d}" for i in range(PT_SYMBOLS)]
    data = stock_data(n, seed=7)
    data["symbol"] = np.random.default_rng(7).integers(1, PT_SYMBOLS + 1,
                                                       size=n).astype(np.int32)
    return data, names


def partition_pattern_path_phase(torch) -> dict:
    """Patterns inside a partition at full width: `partition with (symbol
    of StockStream)`, @app:batch 32768, @app:partitionCapacity 1024 (1,000
    symbols drawn uniformly, 1 ms ticks), the default patternCapacity 128
    a partition (131,072 token lanes).

    PPF (the fast route, K34/K36): every e1[price > 95] -> e2[price < 5]
    within 1 min, 1,000,000 events in calls of 8 batches (the first of 4),
    per batch; launches of this run alone held to their uses a step (512
    chunks of 64 rows: two K34 passes and one K36 a chunk) times the steps;
    events/s, the device busy share of one more call of 8 batches and where
    a call's time goes (`call_breakdown`); the first 4,096 events against
    device="cpu".

    PPC (the count route, K35/K36): every a1[price > 90]<2:4> ->
    a2[price < 10], the same traffic and checks but the breakdown (128
    chunks of 256 rows).

    PPA (the scan, K37, with its TIMER steps): every e1[price > 95] -> not
    [price < 5] for 100 milliseconds under @app:playback, PPA_BATCHES calls
    of one batch: each call's data step, then one TIMER step per distinct
    deadline, each over every slot; K37, the row lists and the placement
    launched once a step (data or TIMER); the first 1,024 events against
    device="cpu" in calls of 512; the device busy share of one more
    call."""
    from siddhi_tpu_torch import kernels

    out = {}
    b = MAIN_BATCH
    data, names = pp_data(PP_EVENTS)
    for label, wanted in (("PPF", PPF_KERNELS), ("PPC", PPC_KERNELS)):
        app = partition_pattern_app(label, b, PT_CAP)
        first_n, stride = 4 * b, 8 * b
        run_app("cuda", app, data, 2 * b, b, b, fused=False, symbols=names)  # warm-up
        kernels.launches.clear()
        (n_rows, kept, dt, _i), warned = capture_warnings(
            lambda: run_app("cuda", app, data, PP_EVENTS, stride, first_n, fused=False,
                            symbols=names), "patternCapacity")
        launches = dict(kernels.launches)
        steps = sum(-(-c // b) for c in call_sizes(PP_EVENTS, first_n, stride))
        print(f"path {label} launches {json.dumps(launches)} over {steps} steps", flush=True)
        if warned:
            raise AssertionError(f"path {label}: a token table or emission buffer overflowed")
        held_launches(label, launches, wanted, steps)
        cpu = cpu_check(f"path {label}", app, data, PP_CPU_EVENTS, symbols=names,
                        n=PP_CPU_EVENTS)
        if not n_rows:
            raise AssertionError(f"path {label}: no rows delivered")
        wall_ms, busy_ms = fused_busy(torch, app, data, b, symbols=names)
        out[label] = {"events": PP_EVENTS, "rows": n_rows, "seconds": dt,
                      "events_per_s": PP_EVENTS / dt, "steps": steps, "launches": launches,
                      "cpu_check": cpu, "busy_call_wall_ms": wall_ms,
                      "busy_call_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms}
        if label == "PPF":
            out[label]["breakdown"] = call_breakdown(torch, app, data, b, names)
        print(f"path {label}: {PP_EVENTS} events per batch, {n_rows} rows delivered, "
              f"{dt:.3f} s, {PP_EVENTS / dt:.1f} events/s; one call of 8 batches: wall "
              f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.4f}); the "
              f"first {PP_CPU_EVENTS} events match device='cpu'", flush=True)

    # ---- PPA
    app = partition_pattern_app("PPA", b, PT_CAP)
    run_app("cuda", app, data, b, b, b, fused=False, symbols=names)  # warm-up
    fires = [0]
    n = PPA_BATCHES * b
    kernels.launches.clear()
    (n_rows, kept, dt, _i), warned = capture_warnings(
        lambda: run_app("cuda", app, data, n, b, b, fused=False, fires=fires, symbols=names),
        "patternCapacity")
    launches = dict(kernels.launches)
    print(f"path PPA launches {json.dumps(launches)} over {PPA_BATCHES} data and {fires[0]} "
          "TIMER steps", flush=True)
    if warned:
        raise AssertionError("path PPA: a token table or emission buffer overflowed")
    if fires[0] <= 0 or not n_rows:
        raise AssertionError(f"path PPA: {fires[0]} TIMER steps, {n_rows} rows")
    steps = PPA_BATCHES + fires[0]
    held_launches("PPA", launches, {"pattern_place": 1, "partition_rows": 1}, steps)
    held_launches("PPA", launches, {"assign_slots": 1}, PPA_BATCHES)
    reruns = launches.get("partition_pattern_scan", 0) - steps
    if reruns < 0:
        raise AssertionError(f"path PPA: {launches.get('partition_pattern_scan', 0)} K37 "
                             f"launches for {steps} steps")
    cpu = cpu_check("path PPA", app, data, PPA_CPU_EVENTS // 2, symbols=names,
                    n=PPA_CPU_EVENTS)
    wall_ms, busy_ms = calls_busy(torch, app, data, b, 1, 1, ("symbol", "price", "volume"),
                                  names)
    out["PPA"] = {"events": n, "rows": n_rows, "seconds": dt, "events_per_s": n / dt,
                  "data_steps": PPA_BATCHES, "timer_steps": fires[0], "reruns": reruns,
                  "launches": launches, "cpu_check": cpu, "busy_call_wall_ms": wall_ms,
                  "busy_call_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms}
    print(f"path PPA absent pattern, playback: {n} events in {PPA_BATCHES} calls and "
          f"{fires[0]} TIMER steps over every slot ({reruns} steps ran again for their "
          f"emissions), {n_rows} rows delivered, {dt:.3f} s, {n / dt:.1f} events/s; one more "
          f"call: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({busy_ms / wall_ms:.4f}); the first {PPA_CPU_EVENTS} events match device='cpu'",
          flush=True)
    return out


PJ_PATH_KERNELS = {
    "PJ": {"assign_slots": 1, "partition_length_window_step": 1, "partition_ring_view": 1,
           "partition_join_assemble": 1},
    "PSW": {"assign_slots": 1, "partition_rows": 1, "partition_sort_window_step": 1,
            "pattern_place": 1, "keyed_running_sum": 2},
    "PFQ": {"assign_slots": 1, "partition_rows": 1, "partition_frequent_window_step": 1,
            "pattern_place": 1, "keyed_running_sum": 1},
}
PJ_CALLS, PSW_EVENTS = 16, 262_144


def run_streams(dev, app: str, feeds: list, b: int, calls: int, symbols, keep_calls: int = 1,
                profile=None):
    """Drive a multi-stream app: each call sends one batch of `b` events to
    each stream of `feeds` [(stream, data)] in turn, through send_columns.
    Returns (delivered rows, rows of each of the first `keep_calls` calls,
    seconds). With `profile` (torch.profiler's profile class), the last
    call runs under it and its device busy ms is returned as a fourth
    value with the call's wall ms."""
    import torch

    from siddhi_tpu_torch import SiddhiManager

    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(app)
    for s in symbols:
        mgr.interner.intern(s)
    count, kept = [0], []

    def on_rows(t, ins, rem):
        count[0] += len(ins or [])
        if len(kept) <= keep_calls:
            kept[-1].extend(tuple(e.data) for e in ins or [])

    rt.add_callback("q", on_rows)
    rt.start()
    hs = {sid: rt.get_input_handler(sid) for sid, _d in feeds}

    def call(c):
        kept.append([])
        lo, hi = c * b, (c + 1) * b
        for sid, data in feeds:
            hs[sid].send_columns(data["ts"][lo:hi], {k: data[k][lo:hi]
                                                     for k in ("symbol", "price", "volume")},
                                 now=0)

    if dev != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in range(calls - (profile is not None)):
        call(c)
    if dev != "cpu":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    busy = None
    if profile is not None:
        from torch.profiler import ProfilerActivity

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            call(calls - 1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        busy_us = 0.0
        for e in prof.key_averages():
            dev_us = getattr(e, "self_device_time_total", None)
            busy_us += e.self_cuda_time_total if dev_us is None else dev_us
        busy = (wall * 1e3, busy_us / 1e3)
    rt.shutdown()
    mgr.shutdown()
    return count[0], kept[:keep_calls], dt, busy


def partition_join_path_phase(torch) -> dict:
    """Joins and the sort and frequent windows inside a partition at full
    width: @app:batch 32768, @app:partitionCapacity 1024, 1,000 symbols
    drawn uniformly (seed-7 stock data, 1 ms ticks).

    PJ (PJ_APPS): `Trades#window.length(50) as t join
    Quotes#window.length(50) as q on t.volume == q.volume` per symbol, the
    quotes from seed 8; PJ_CALLS calls of one batch a stream (Trades then
    Quotes), each batch one step; launches of this run held to their uses
    a step times the steps; events/s over both streams; no join overflow;
    the first call (one batch a stream) against device="cpu"; the device
    busy share of one more call.

    PSW: sort(10, price desc, volume asc) with count and sum per symbol,
    `insert all events`, PSW_EVENTS events in calls of 4 batches (the first
    of 1); PFQ: frequent(10, volume) with count, the same way; each with
    its launches held, events/s, the first batch against device="cpu" and
    the busy share of one more call of 4 batches."""
    from torch.profiler import profile

    from siddhi_tpu_torch import kernels

    b = MAIN_BATCH
    out = {}
    trades, names = pp_data(PJ_CALLS * b)
    quotes = stock_data(PJ_CALLS * b, seed=8)
    quotes["symbol"] = np.random.default_rng(8).integers(
        1, PT_SYMBOLS + 1, size=PJ_CALLS * b).astype(np.int32)
    app = partition_join_app("PJ", b, PT_CAP)
    feeds = [("Trades", trades), ("Quotes", quotes)]
    run_streams("cuda", app, feeds, b, 1, names)  # warm-up
    kernels.launches.clear()
    (n_rows, kept, dt, _busy), warned = capture_warnings(
        lambda: run_streams("cuda", app, feeds, b, PJ_CALLS, names))
    launches = dict(kernels.launches)
    steps = 2 * PJ_CALLS
    print(f"path PJ launches {json.dumps(launches)} over {steps} steps", flush=True)
    if warned:
        raise AssertionError("path PJ: the join output overflowed its capacity")
    held_launches("PJ", launches, PJ_PATH_KERNELS["PJ"], steps)
    t0 = time.perf_counter()
    _n, cpu_kept, _dt, _b = run_streams("cpu", app, feeds, b, 1, names)
    cpu_s = time.perf_counter() - t0
    check_path("PJ", launches, PJ_PATH_KERNELS["PJ"], kept, cpu_kept, 1)
    _n, _k, _dt, (wall_ms, busy_ms) = run_streams("cuda", app, feeds, b, 2, names,
                                                  profile=profile)
    n_ev = steps * b
    out["PJ"] = {"events": n_ev, "rows": n_rows, "seconds": dt, "events_per_s": n_ev / dt,
                 "steps": steps, "launches": launches, "cpu_first_call_rows": len(cpu_kept[0]),
                 "cpu_plain_s": cpu_s, "busy_call_wall_ms": wall_ms,
                 "busy_call_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms}
    print(f"path PJ partitioned equality join: {n_ev} events over two streams, {n_rows} rows "
          f"delivered, {dt:.3f} s, {n_ev / dt:.1f} events/s; one call (a batch a stream): "
          f"wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.4f}); "
          f"the first call's {len(cpu_kept[0])} rows match device='cpu'", flush=True)

    data, names = pp_data(PSW_EVENTS + 4 * b)
    for label in ("PSW", "PFQ"):
        app = partition_join_app(label, b, PT_CAP)
        wanted = PJ_PATH_KERNELS[label]
        run_app("cuda", app, data, b, b, b, fused=False, symbols=names)  # warm-up
        kernels.launches.clear()
        (n_rows, kept, dt, _i), warned = capture_warnings(
            lambda: run_app("cuda", app, data, PSW_EVENTS, 4 * b, b, fused=False,
                            symbols=names), "window emission")
        launches = dict(kernels.launches)
        steps = PSW_EVENTS // b
        print(f"path {label} launches {json.dumps(launches)} over {steps} steps", flush=True)
        if warned:
            raise AssertionError(f"path {label}: a window's emission buffer overflowed")
        held_launches(label, launches, wanted, steps)
        t0 = time.perf_counter()
        _n, cpu_kept, _dt, _i = run_app("cpu", app, data, b, b, b, fused=False, symbols=names)
        cpu_s = time.perf_counter() - t0
        check_path(label, launches, wanted, kept, cpu_kept, 1)
        wall_ms, busy_ms = calls_busy(torch, app, data, 4 * b, 1, 1,
                                      ("symbol", "price", "volume"), names)
        out[label] = {"events": PSW_EVENTS, "rows": n_rows, "seconds": dt,
                      "events_per_s": PSW_EVENTS / dt, "steps": steps, "launches": launches,
                      "cpu_first_batch_rows": len(cpu_kept[0]), "cpu_plain_s": cpu_s,
                      "busy_call_wall_ms": wall_ms, "busy_call_busy_ms": busy_ms,
                      "busy_share": busy_ms / wall_ms}
        print(f"path {label}: {PSW_EVENTS} events, {n_rows} rows delivered, {dt:.3f} s, "
              f"{PSW_EVENTS / dt:.1f} events/s; one call of 4 batches: wall {wall_ms:.3f} ms, "
              f"device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.4f}); the first batch's "
              f"{len(cpu_kept[0])} rows match device='cpu'", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 10: the table paths (bench.py:266 _leg_table_scaling's traffic)
# ---------------------------------------------------------------------------

TAB_HEAD = """@app:batch(size='{batch}')
define stream Loader (k long, v long);
define stream S (k long, v long);
"""
TAB_APPS = {
    "TAB-PK": TAB_HEAD + """@PrimaryKey('k')
@capacity(size='{n}')
define table T (k long, v long);
@info(name='load') from Loader insert into T;
@info(name='upd') from S select k, v update T on T.k == k;
""",
    "TAB-DENSE": TAB_HEAD + """define stream D (k long);
@capacity(size='{n}')
define table T (k long, v long);
@info(name='load') from Loader insert into T;
@info(name='upd') from S select k, v update T set T.v = v on T.k >= k and T.k < k + 8;
@info(name='del') from D select k delete T on T.k == k;
""",
    # @Index('k'): the planner indexes only @Index columns and equality
    # update probes, so without it neither package keeps a sorted index here
    "TAB-UPSERT": TAB_HEAD + """@PrimaryKey('k')
@Index('k')
@capacity(size='{n}')
define table T (k long, v long);
@info(name='load') from Loader insert into T;
@info(name='upd') from S select k, v update or insert into T on T.k == k;
""",
    # bench.py:266's leg without @PrimaryKey: the equality `on` auto-indexes
    # k, and each step picks the indexed or the dense path on the device
    # from the index's duplicate flag (K22's probe and K23 gated by it)
    "TAB-IX": TAB_HEAD + """@capacity(size='{n}')
define table T (k long, v long);
@info(name='load') from Loader insert into T;
@info(name='upd') from S select k, v update T on T.k == k;
""",
    "TAB-JOIN": "@app:joinCapacity(size='{batch}')\n" + TAB_HEAD + """define stream Q (k long);
@capacity(size='{n}')
define table T (k long, v long);
@info(name='load') from Loader insert into T;
@info(name='q') from Q join T on Q.k == T.k select Q.k as k, T.v as v insert into Out;
@info(name='q2') from Q[(T.k == k) in T] select k insert into Out2;
""",
}
# per path: the keys loaded (0..) and the probe keys' range, as shares of n
TAB_LOAD = {"TAB-PK": (1.0, 1.0), "TAB-IX": (1.0, 1.0), "TAB-DENSE": (1.0, 1.0),
            "TAB-UPSERT": (0.5, 1.5), "TAB-JOIN": (1.0, 2.0)}
TAB_N = {"TAB-PK": TAB_PK_ROWS, "TAB-IX": TAB_PK_ROWS, "TAB-DENSE": TAB_ROWS,
         "TAB-UPSERT": TAB_ROWS, "TAB-JOIN": TAB_JOIN_ROWS}
# 32 batches a path, a 10-batch per-batch prefix and 1 batch against
# device="cpu" (128, 20 and 4 until the partitioned joins joined the
# script's time, 64 and 2 until the aggregation's did)
TAB_BATCHES, TAB_PREFIX, TAB_CALL, TAB_CPU_BATCHES, TAB_PK_CPU_ROWS = 16, 5, 8, 1, 65_536


def fused_steps(n: int, b: int, k: int = 32) -> int:
    """The query steps one send_columns call of n events runs at batch b:
    per batch under 2 batches, else fused chunks of k batches, a short tail
    padded to the smallest power of two that holds it (FusedJunctionIngest
    ._chunk_K; the padding's empty batches step too)."""
    batches = -(-n // b)
    if batches < 2:
        return batches
    steps = 0
    while batches > 0:
        kk = k if batches >= k else min(k, 1 << max(1, (batches - 1).bit_length()))
        steps += kk
        batches -= kk
    return steps


def run_table_path(dev: str, label: str, n: int, batch: int, n_batches: int, fused: bool = True,
                   busy: bool = False) -> dict:
    """One table path: the app of TAB_APPS at capacity n and @app:batch
    `batch`; the table loaded with keys 0.. through `from Loader insert into
    T` (one send_columns call); then `n_batches` batches of the traffic of
    bench.py:266 (keys uniform from the path's range with default_rng(3),
    values arange) in send_columns calls of 8 batches (fused once 2 batches
    or more; `fused=False` detaches the fused engines); TAB-DENSE also
    deletes one batch of keys (default_rng(4)) after every second call.
    Returns the table's rows in order, the callback rows, the traffic's
    seconds (after a device sync) and the steps of the probing stream; with
    `busy`, the wall and device busy ms of one more fused call."""
    import torch

    from siddhi_tpu_torch import SiddhiManager

    mgr = SiddhiManager(device=dev)
    rt = mgr.create_siddhi_app_runtime(TAB_APPS[label].format(batch=batch, n=n))
    got: dict = {q: [] for q in ("q", "q2") if q in rt.queries}
    for q, rows in got.items():
        rt.add_callback(q, lambda t, ins, rem, _r=rows: _r.extend(tuple(e.data) for e in ins or []))
    rt.start()
    if not fused:
        for j in rt.junctions.values():
            j.fused_ingest = None
    load, span = TAB_LOAD[label]
    lk = np.arange(int(n * load), dtype=np.int64)
    rt.get_input_handler("Loader").send_columns(lk, {"k": lk, "v": lk})
    total = batch * n_batches
    ks = np.random.default_rng(3).integers(0, int(n * span), size=total).astype(np.int64)
    vs = np.arange(total, dtype=np.int64)
    dk = np.random.default_rng(4).integers(0, n, size=total).astype(np.int64)
    stream = "Q" if label == "TAB-JOIN" else "S"
    h = rt.get_input_handler(stream)
    hd = rt.get_input_handler("D") if label == "TAB-DENSE" else None

    def call(lo, hi, c):
        cols = {"k": ks[lo:hi]} if stream == "Q" else {"k": ks[lo:hi], "v": vs[lo:hi]}
        h.send_columns(vs[lo:hi], cols)
        if hd is not None and c % 2 == 1:
            hd.send_columns(vs[lo:lo + batch], {"k": dk[lo:lo + batch]})

    if dev == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c, lo in enumerate(range(0, total, TAB_CALL * batch)):
        call(lo, min(total, lo + TAB_CALL * batch), c)
    if dev == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    from siddhi_tpu_torch import kernels

    out = {"table": [tuple(e.data) for e in rt.query("from T select k, v")], "rows": got,
           "seconds": dt, "launches": dict(kernels.launches)}
    if busy:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            call(0, TAB_CALL * batch, 0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        busy_us = 0.0
        for e in prof.key_averages():
            dev_us = getattr(e, "self_device_time_total", None)
            busy_us += e.self_cuda_time_total if dev_us is None else dev_us
        out["busy"] = {"wall_ms_8_batches": wall * 1e3, "device_busy_ms": busy_us / 1e3,
                       "share": busy_us / 1e3 / (wall * 1e3)}
    rt.shutdown()
    mgr.shutdown()
    return out


def table_path_phase(torch, label: str, expected) -> dict:
    """One table path at its realistic size (TAB_N, B=8192): 32 batches
    fused, with the launch counts of this run alone (from 0 just before the
    app is built, through the load and the traffic) equal to
    `expected(load batches, batches)`; events/s and the device busy share of
    one more fused call; the table (and the callback rows) after a 10-batch
    fused run equal to the per-batch form's; the first batch against
    device="cpu" (TAB-PK and TAB-IX at capacity 65,536); the overflow flag logged
    where the path fills its table (TAB-UPSERT) and no other flag."""
    from siddhi_tpu_torch import kernels

    b, n, depth, prefix = TAB_BATCH, TAB_N[label], TAB_BATCHES, TAB_PREFIX
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger("siddhi_tpu_torch").addHandler(handler)
    try:
        kernels.launches.clear()
        main = run_table_path("cuda", label, n, b, depth, busy=True)
    finally:
        logging.getLogger("siddhi_tpu_torch").removeHandler(handler)
    launches = main["launches"]
    print(f"{label} launches {json.dumps(launches)}", flush=True)
    want = expected(fused_steps(int(n * TAB_LOAD[label][0]), b), depth)
    for k, w in want.items():
        if launches.get(k, 0) != w:
            raise AssertionError(f"{label}: {k} launched {launches.get(k, 0)} times, not {w}")
    logged = [r.getMessage() for r in records]
    overflow = any("ran out of capacity" in m for m in logged)
    if overflow != (label == "TAB-UPSERT") or any("primary key" in m for m in logged):
        raise AssertionError(f"{label}: unexpected flag logs {logged}")
    fused = run_table_path("cuda", label, n, b, prefix)
    pb = run_table_path("cuda", label, n, b, prefix, fused=False)
    if fused["table"] != pb["table"] or fused["rows"] != pb["rows"]:
        raise AssertionError(f"{label}: the fused run's table differs from the per-batch form's")
    cn = TAB_PK_CPU_ROWS if label in ("TAB-PK", "TAB-IX") else n
    t_cpu = time.perf_counter()
    on_cpu = run_table_path("cpu", label, cn, b, TAB_CPU_BATCHES)
    cpu_s = time.perf_counter() - t_cpu
    on_card = run_table_path("cuda", label, cn, b, TAB_CPU_BATCHES)
    if on_card["table"] != on_cpu["table"] or on_card["rows"] != on_cpu["rows"]:
        raise AssertionError(f"{label}: the first {TAB_CPU_BATCHES} batches differ from "
                             "device='cpu'")
    events = b * depth
    out = {"capacity": n, "batch": b, "batches": depth, "events": events,
           "seconds": main["seconds"], "events_per_s": events / main["seconds"],
           "table_rows": len(main["table"]),
           "callback_rows": {q: len(r) for q, r in main["rows"].items()},
           "launches": launches, "busy": main["busy"], "overflow_logged": overflow,
           "per_batch_prefix": {"batches": prefix, "table_rows": len(pb["table"]),
                                "equal": True},
           "cpu_check": {"capacity": cn, "batches": TAB_CPU_BATCHES,
                         "table_rows": len(on_cpu["table"]), "cpu_seconds": cpu_s}}
    print(f"path {label}: capacity {n}, {events} events in {main['seconds']:.3f} s, "
          f"{events / main['seconds']:.1f} events/s fused, {len(main['table'])} table rows, "
          f"callback rows {out['callback_rows']}; device busy "
          f"{main['busy']['device_busy_ms']:.3f} of {main['busy']['wall_ms_8_batches']:.3f} ms "
          f"over one fused call of 8 batches ({main['busy']['share']:.4f}); {prefix}-batch "
          f"table equal to the per-batch form's; first {TAB_CPU_BATCHES} batches equal to device='cpu' at "
          f"capacity {cn} ({cpu_s:.1f} s on the host)", flush=True)
    return out


def table_paths_phase(torch) -> dict:
    """The table paths (see table_path_phase), each kernel's launches held
    to its steps, L being the load's steps (fused_steps) and `steps` the
    path's batches: TAB-PK, K21 and K22's rebuild a load batch (and once
    when the update indexes k at app creation), K22's probe a step; TAB-IX
    as TAB-PK, and K23 (gated off by the index's duplicate flag) a step;
    TAB-DENSE, K23 an update step and a delete step; TAB-UPSERT, K24 and
    K22's rebuild a step; TAB-JOIN, K12 and K23 (`in`) a probe step."""
    return {
        "TAB-PK": table_path_phase(torch, "TAB-PK", lambda L, steps: {
            "table_write": L, "table_index_build": L + 1, "table_index_probe": steps}),
        "TAB-IX": table_path_phase(torch, "TAB-IX", lambda L, steps: {
            "table_write": L, "table_index_build": L + 1, "table_index_probe": steps,
            "table_match": steps}),
        "TAB-DENSE": table_path_phase(torch, "TAB-DENSE", lambda L, steps: {
            "table_write": L, "table_match": steps + steps // (2 * TAB_CALL)}),
        "TAB-UPSERT": table_path_phase(torch, "TAB-UPSERT", lambda L, steps: {
            "table_write": L, "table_index_build": L + steps, "table_scan": steps}),
        "TAB-JOIN": table_path_phase(torch, "TAB-JOIN", lambda L, steps: {
            "table_write": L, "table_match": steps, "join_assemble": steps}),
    }


def profile_phase(torch, app: str, b: int) -> dict:
    """Where one full-width batch of `app` spends its time (B = b):
    host stages timed around torch.cuda.synchronize(),
    torch.profiler's device time by kernel over 4 batches, then cProfile's
    host time by function over the real send_columns loop (16 batches)."""
    from torch.profiler import ProfilerActivity, profile

    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core.join import JoinQueryRuntime
    from siddhi_tpu_torch.core.pattern_runtime import PatternQueryRuntime

    data = stock_data(16 * b, seed=7)
    data["ets"] = data["ts"].copy()  # path XB's event-time attribute
    mgr = SiddhiManager()
    rt = mgr.create_siddhi_app_runtime(app)
    for s in SYMBOLS:
        mgr.interner.intern(s)
    rows = [0]
    rt.add_callback("q", lambda t, ins, rem: rows.__setitem__(0, rows[0] + len(ins or [])))
    rt.start()
    j, qr = rt.junctions["StockStream"], rt.queries["q"]
    encode, decode = j.schema.packed_codec(b, j.device)
    cols = tuple(j.schema.attr_names)
    stages = {"encode": 0.0, "h2d_and_step": 0.0, "d2h_decode_deliver": 0.0}
    # a self-join runs its left then its right step on every batch; a
    # pattern's step is per input stream
    sides = (("l", "r") if isinstance(qr, JoinQueryRuntime) else
             ("StockStream",) if isinstance(qr, PatternQueryRuntime) else (None,))

    def one(i, timed):
        lo, hi = i * b, (i + 1) * b
        t0 = time.perf_counter()
        buf = encode(data["ts"][lo:hi], {k: data[k][lo:hi] for k in cols}, b)
        t1 = time.perf_counter()
        batch = decode(buf, b)
        outs = [qr.receive(batch, 0) if sd is None else qr.receive(batch, 0, sd) for sd in sides]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for out in outs:
            qr.route_output(out, 0, rt._decode)
        t3 = time.perf_counter()
        if timed:
            stages["encode"] += t1 - t0
            stages["h2d_and_step"] += t2 - t1
            stages["d2h_decode_deliver"] += t3 - t2

    for i in range(2):
        one(i, False)
    n_timed = 8
    for i in range(2, 2 + n_timed):
        one(i, True)
    per_batch_ms = {k: v / n_timed * 1e3 for k, v in stages.items()}
    print(f"profile: host stages per batch (ms, synchronized): {json.dumps(per_batch_ms)}",
          flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(10, 14):
            one(i, False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels_by_name = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            kernels_by_name.append((e.key, e.count, dev_us / 1e3))
    kernels_by_name.sort(key=lambda k: -k[2])
    busy_ms = sum(k[2] for k in kernels_by_name)
    print(f"profile: 4 batches, wall {wall * 1e3:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({busy_ms / (wall * 1e3):.4f} of wall)", flush=True)
    for name, count, ms in kernels_by_name[:15]:
        print(f"profile:   {ms:10.3f} ms  x{count:<5d} {name[:90]}", flush=True)
    rt.shutdown()

    # the host side of the real loop: send_columns over 16 batches, unsynchronized
    import cProfile
    import pstats

    prof_host = cProfile.Profile()
    prof_host.enable()
    t0 = time.perf_counter()
    run_app("cuda", app, data, 16 * b, 8 * b, 8 * b, fused=False, cols=cols)
    loop_s = time.perf_counter() - t0
    prof_host.disable()
    stats = pstats.Stats(prof_host)
    top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:20]  # by own time
    print(f"profile: per-batch send_columns loop, 16 batches: {loop_s * 1e3 / 16:.3f} "
          "ms/batch (incl. app build); top host functions by own time:", flush=True)
    by_func = []
    for (file, line, fn), (_cc, ncalls, tottime, cumtime, _callers) in top:
        where = f"{os.path.basename(file)}:{line}({fn})"
        by_func.append((where, ncalls, tottime * 1e3, cumtime * 1e3))
        print(f"profile:   {tottime * 1e3:9.2f} ms own {cumtime * 1e3:9.2f} ms cum "
              f"x{ncalls:<7d} {where}", flush=True)
    return {"host_stage_ms_per_batch": per_batch_ms, "wall_ms_4_batches": wall * 1e3,
            "device_busy_ms_4_batches": busy_ms, "by_kernel": kernels_by_name,
            "loop_ms_per_batch": loop_s * 1e3 / 16, "host_by_function": by_func}


def profile_fused(torch, app: str, b: int) -> dict:
    """Where one fused chunk of `app` spends its time (K=8 batches of
    B = b): the engine's own stages, each timed around
    torch.cuda.synchronize() — host encode into a pooled pinned slot, H2D,
    K4 + the K steps + K5, the drain's readbacks, host decode + callbacks —
    averaged over 4 chunks; then torch.profiler's device time by kernel and
    the device busy share over 4 chunks sent as one send_columns call (the
    real pipelined path)."""
    from torch.profiler import ProfilerActivity, profile

    from siddhi_tpu_torch import SiddhiManager

    K = 8
    data = stock_data(12 * K * b, seed=7)
    data["ets"] = data["ts"].copy()  # path XB's event-time attribute
    mgr = SiddhiManager()
    rt = mgr.create_siddhi_app_runtime(app)
    for s in SYMBOLS:
        mgr.interner.intern(s)
    rows = [0]
    rt.add_callback("q", lambda t, ins, rem: rows.__setitem__(0, rows[0] + len(ins or [])))
    rt.start()
    cols = tuple(rt.junctions["StockStream"].schema.attr_names)
    fi = rt.junctions["StockStream"].fused_ingest
    h = rt.get_input_handler("StockStream")

    def send(c0, c1):
        lo, hi = c0 * K * b, c1 * K * b
        h.send_columns(data["ts"][lo:hi], {k: data[k][lo:hi] for k in cols}, now=0)

    send(0, 2)  # engages: wire chosen, program formed, drain worker up
    prog, pl = fi._prog, fi._pipeline()
    (i,) = prog.deliver_idx
    W = prog.layouts[i][1]
    n_out = K * fi.endpoints[i].outputs  # output batches in the pack
    hdr = -(-4 * n_out // W)
    stages = dict.fromkeys(("encode", "h2d", "k4_steps_k5", "d2h", "decode_deliver"), 0.0)

    def chunk(c, timed):
        lo, hi = c * K * b, (c + 1) * K * b
        t0 = time.perf_counter()
        slot = pl.acquire(K, prog.wire_bytes)
        fi._encode_chunk(prog.encode, data["ts"][lo:hi], {k: data[k][lo:hi] for k in cols},
                         0, hi - lo, b, K, prog.wire_bytes, slot=slot)
        t1 = time.perf_counter()
        wire, counts, bases = pl.ship(slot)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        packs, event = fi._dispatch_chunk(prog, wire, counts, bases, K, hi - lo, 0)
        pl.retire(slot)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        head = fi._readback(packs[0], 0, hdr, event)
        cnts = head.reshape(-1)[: 4 * n_out].view(np.int32)
        total = int(cnts.sum())
        host = fi._readback(packs[0], hdr, hdr + total, None)
        t4 = time.perf_counter()
        fi.deliver_endpoint(prog, i, host, cnts, total)
        t5 = time.perf_counter()
        if timed:
            for k, v in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
                stages[k] += v

    chunk(2, False)
    for c in range(3, 7):
        chunk(c, True)
    per_chunk_ms = {k: v / 4 * 1e3 for k, v in stages.items()}
    print(f"profile: fused chunk stages (ms per K=8 chunk, synchronized): "
          f"{json.dumps(per_chunk_ms)}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        send(7, 11)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            by_kernel.append((e.key, e.count, dev_us / 1e3))
    by_kernel.sort(key=lambda k: -k[2])
    busy_ms = sum(k[2] for k in by_kernel)
    print(f"profile: fused, 4 chunks (32 batches) in one send_columns: wall {wall * 1e3:.3f} ms, "
          f"device busy {busy_ms:.3f} ms ({busy_ms / (wall * 1e3):.4f} of wall)", flush=True)
    for name, count, ms in by_kernel[:15]:
        print(f"profile:   {ms:10.3f} ms  x{count:<5d} {name[:90]}", flush=True)
    rt.shutdown()
    return {"stage_ms_per_chunk": per_chunk_ms, "wall_ms_4_chunks": wall * 1e3,
            "device_busy_ms_4_chunks": busy_ms, "by_kernel": by_kernel}


def profile_timers(torch, app: str, b: int, label: str = "time join") -> dict:
    """Where path T's (or A's) time goes: 4 calls of one batch each through the real
    send_columns loop under @app:playback (after 2 warm-up calls), with the
    one-row TIMER steps the event-time clock sends counted and timed apart
    from the data steps; then torch.profiler's device busy share over 1
    call."""
    from torch.profiler import ProfilerActivity, profile

    from siddhi_tpu_torch import SiddhiManager

    data = stock_data(8 * b, seed=7)
    cols = ("symbol", "price", "volume")
    mgr = SiddhiManager()
    rt = mgr.create_siddhi_app_runtime(app)
    for s in SYMBOLS:
        mgr.interner.intern(s)
    rows = [0]
    rt.add_callback("q", lambda t, ins, rem: rows.__setitem__(0, rows[0] + len(ins or [])))
    rt.start()
    rt.junctions["StockStream"].fused_ingest = None
    qr = rt.queries["q"]
    timer = {"steps": 0, "s": 0.0}
    for side, fire in list(qr.timer_targets.items()):
        def timed(t_ms, _fire=fire):
            t0 = time.perf_counter()
            _fire(t_ms)
            timer["steps"] += 1
            timer["s"] += time.perf_counter() - t0

        qr.timer_targets[side] = timed
    h = rt.get_input_handler("StockStream")

    def send(c):
        lo, hi = c * b, (c + 1) * b
        h.send_columns(data["ts"][lo:hi], {k: data[k][lo:hi] for k in cols}, now=0)

    send(0)
    send(1)
    timer.update(steps=0, s=0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in range(2, 6):
        send(c)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"calls": 4, "wall_ms_per_call": wall / 4 * 1e3,
           "timer_steps_per_call": timer["steps"] / 4,
           "timer_ms_per_call": timer["s"] / 4 * 1e3,
           "timer_ms_per_step": timer["s"] / max(timer["steps"], 1) * 1e3}
    print(f"profile: {label}, per call of one batch: {json.dumps(out)}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        send(6)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_ms = sum(getattr(e, "self_device_time_total", 0) / 1e3 for e in prof.key_averages())
    out.update(profiled_call_wall_ms=wall * 1e3, profiled_call_busy_ms=busy_ms)
    print(f"profile: {label}, 1 call: wall {wall * 1e3:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({busy_ms / (wall * 1e3):.4f} of wall)", flush=True)
    rt.shutdown()
    return out


# ---------------------------------------------------------------------------
# phase 2: the redesigned K11/K48 and row lists, and the float32 subnormals
# ---------------------------------------------------------------------------



def fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def three_times(torch, fn, reps: int, names) -> dict:
    """One call timed three ways: `ms` the whole call (CUDA events around
    back-to-back calls: host work shows where it outlasts the device's),
    `device_ms` its device work alone (`device_all_ms`), `kernel_ms`
    torch.profiler's sum of the kernels whose names hold one of `names`
    (None: every kernel of the call; None when the profiler recorded none,
    as it can late in a long run)."""
    out = {"ms": time_ms(torch, fn, reps), "device_ms": device_all_ms(torch, fn, reps)}
    try:
        out["kernel_ms"] = device_ms(torch, lambda: None, fn, max(reps // 4, 5), names)
    except AssertionError:
        out["kernel_ms"] = None
    return out


def view_ring(torch, rng, dev, w: int, live: int, holes: bool = False, lanes=None) -> dict:
    """A sliding ring's state of W slots for K11/K48: `live` slots hold the
    last seqs (in ring order, or scattered with `holes`), the rest -1; the
    stock lanes (price with NaN), or `lanes` int32/bool lanes."""
    total = 3 * w + 5000
    seq = np.full(w, -1, np.int64)
    n = min(live, w)
    s = np.arange(total - n, total, dtype=np.int64)
    if holes:
        seq[rng.permutation(w)[:n]] = rng.permutation(s)
    else:
        seq[s % w] = s
    if lanes is None:
        price = rng.uniform(0, 100, w).astype(np.float32)
        price[rng.random(w) < 0.1] = np.nan
        cols = {"symbol": rng.integers(0, 9, w).astype(np.int32), "price": price,
                "volume": rng.integers(1, 1000, w).astype(np.int64)}
    else:
        cols = {f"c{i}": (rng.random(w) < 0.5 if i % 3 == 0
                          else rng.integers(-9, 9, w).astype(np.int32)) for i in range(lanes)}
    return {"cols": {k: torch.from_numpy(v).to(dev) for k, v in cols.items()},
            "ts": torch.from_numpy(rng.integers(0, 1 << 40, w)).to(dev),
            "seq": torch.from_numpy(seq).to(dev),
            "total": torch.tensor(total, dtype=torch.int64, device=dev)}


VIEW_SEED, ROWS_SEED, ROWS_TIMING_SEED = 1911, 1912, 1914


def view_timing_rings(torch, rng, dev) -> tuple:
    """K11's timed rings, the first draws of `rng` (VIEW_SEED): path J's
    length(100), full, and path T's 1,024-slot time ring, 700 live with
    holes."""
    return view_ring(torch, rng, dev, JOIN_W, JOIN_W), view_ring(torch, rng, dev, TIME_W, 700,
                                                                 holes=True)


def rows_batch(torch, rng, dev, bsz: int, p: int, timer=0.05, valid=0.9, oob=0.05,
               keys=None) -> tuple:
    """A batch for the row lists and its int32 slots: a `timer` share of
    TIMER rows, 3% EXPIRED, a `valid` share valid, an `oob` share of slots
    out of [0, P); slots uniform over P, or `keys`."""
    from siddhi_tpu_torch.core.event import EventBatch

    u = rng.random(bsz)
    kind = np.where(u < timer, 2, np.where(u < timer + 0.03, 1, 0)).astype(np.int8)
    slot = rng.integers(0, p, bsz) if keys is None else keys
    bad = rng.random(bsz) < oob
    slot = np.where(bad, rng.choice(np.array([-1, p, p + 7]), bsz), slot).astype(np.int32)
    bt = EventBatch(ts=torch.arange(bsz, dtype=torch.int64, device=dev),
                    kind=torch.from_numpy(kind).to(dev),
                    valid=torch.from_numpy(rng.random(bsz) < valid).to(dev), cols={})
    return bt, torch.from_numpy(slot).to(dev)


def rows_timing_batches(torch, dev, p: int) -> dict:
    """The row lists' timed batches (ROWS_TIMING_SEED): PPA's data step and
    PTE's batch (B=32,768 CURRENT rows over 1,000 keys) and a TIMER step
    (B=1)."""
    rng = np.random.default_rng(ROWS_TIMING_SEED)
    data = rows_batch(torch, rng, dev, MAIN_BATCH, p, timer=0.0, valid=1.0, oob=0.0,
                      keys=rng.integers(0, 1000, MAIN_BATCH))
    return {"B32768": data, "B1": rows_batch(torch, rng, dev, 1, p, timer=1.0, valid=1.0, oob=0.0)}


def ring_view_kernel_phase(torch, dev) -> dict:
    """K11 (`ring_view`, one launch a view) and K48 (its seq lane, with the
    view or alone) against their plain versions on the card, bit for bit:
    rings of W 1, 16, 100 (path J's length(100), full), 1,024 (path T's
    time ring) and 57,345 (past shared memory: the global scratch), full,
    rotated, with holes scattered, and empty; a ring of 40 lanes (two
    launches).
    Times at J's ring (W=100), T's (W=1,024 with holes) and LIN's (J's with
    the seq lane) three ways (`three_times`), beside one stable
    `torch.argsort(seq)` and the whole function as stock calls (that
    argsort and one `index_select` a lane) timed alike (PERF.md §6)."""
    from siddhi_tpu_torch.core import windows as W

    rng = np.random.default_rng(VIEW_SEED)
    res = {"checks": 0}

    def ring(w, live, holes=False, lanes=None):
        return view_ring(torch, rng, dev, w, live, holes, lanes)

    def check(label, st):
        for with_seq in (False, True):
            got = W.ring_view(st, with_seq=with_seq)
            want = W.ring_view(to_cpu(st), with_seq=with_seq)
            torch.cuda.synchronize()
            same_bits(torch, [x.cpu() if not isinstance(x, dict) else to_cpu(x) for x in got],
                      list(want))
            res["checks"] += 1
        got = W.ring_view_seq(st)
        torch.cuda.synchronize()
        same_bits(torch, got.cpu(), W.ring_view_seq_ref(to_cpu(st)))
        res["checks"] += 1
        print(f"kernel check ring_view {label} W={st['seq'].shape[0]}: "
              f"{int((st['seq'] >= 0).sum())} live slots, view, view with seq, seq alone: "
              "exact", flush=True)

    j_ring, t_ring = view_timing_rings(torch, rng, dev)
    cases = [("J", j_ring), ("T", t_ring), ("W1", ring(1, 1)), ("W1 empty", ring(1, 0)),
             ("W16 rotated", ring(16, 16)), ("W16 holes", ring(16, 9, holes=True)),
             ("W1024 holes", ring(1024, 3, holes=True)), ("W1024 full", ring(1024, 1024)),
             ("empty", ring(64, 0)), ("40 lanes", ring(16, 11, holes=True, lanes=40)),
             ("global scratch", ring(57_345, 40_000, holes=True))]
    for label, st in cases:
        check(label, st)

    names = ("view_kernel(",)
    col_bytes = 4 + 4 + 8
    for label, st, with_seq in (("J", j_ring, False), ("T", t_ring, False),
                                ("LIN", j_ring, True)):
        w = st["seq"].shape[0]
        seq = st["seq"]
        lanes = [*st["cols"].values(), st["ts"]]
        r = three_times(torch, lambda: W.ring_view(st, with_seq=with_seq), 200, names)
        r["seq_alone"] = three_times(torch, lambda: W.ring_view_seq(st), 200, names)
        r["library_argsort"] = three_times(torch, lambda: torch.argsort(seq, stable=True), 200,
                                           None)

        def whole():
            perm = torch.argsort(seq, stable=True)
            return [x.index_select(0, perm) for x in lanes + ([seq] if with_seq else [])]

        r["library_whole"] = three_times(torch, whole, 200, None)
        r["plain_ms"] = time_ms(torch, lambda: W.ring_view_ref(st), 50)
        r["bound_ms"] = w * (8 + 2 * (col_bytes + 8) + 1 + (8 if with_seq else 0)) \
            / MEM_BYTES_PER_S * 1e3
        res[label] = r
        print(f"kernel ring_view {label} W={w}{' with seq' if with_seq else ''}: "
              f"ms={r['ms']:.4f} device_ms={r['device_ms']:.4f} kernel_ms={fmt(r['kernel_ms'])}; "
              f"argsort {r['library_argsort']['ms']:.4f}/{r['library_argsort']['device_ms']:.4f}/"
              f"{fmt(r['library_argsort']['kernel_ms'])}; argsort + index_select a lane "
              f"{r['library_whole']['ms']:.4f}/{r['library_whole']['device_ms']:.4f}/"
              f"{fmt(r['library_whole']['kernel_ms'])}; seq alone {r['seq_alone']['ms']:.4f}/"
              f"{r['seq_alone']['device_ms']:.4f}/{fmt(r['seq_alone']['kernel_ms'])}; "
              f"plain {r['plain_ms']:.4f}; bound {r['bound_ms']:.7f}", flush=True)
    return {"ring_view_times": res}


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree.cpu() if hasattr(tree, "cpu") else tree


def row_lists_kernel_phase(torch, dev) -> dict:
    """The row lists (csrc/partition_rows.cuh, through `partition_rows`'
    pt_rows, which K31, K32 and K37 share) against the plain version on the
    card, bit for bit: rank, rowlist, slot_start, the TIMER rows, info and each
    slot's rows, at B 1/33/2,048/2,049/32,768 and P 1/33/1,024 with TIMER,
    EXPIRED, invalid and out-of-range rows, and all-TIMER, no-TIMER and
    all-invalid batches. Times three ways (`three_times`) at PPA's data
    step and PTE's batch (B=32,768, P=1,024, 1,000 keys) and a TIMER step
    (B=1), beside one stable `torch.sort` of the rows' keys timed alike."""
    from siddhi_tpu_torch.ops import partition as K

    rng = np.random.default_rng(ROWS_SEED)
    res = {"checks": 0}

    def batch_of(bsz, p, **kw):
        return rows_batch(torch, rng, dev, bsz, p, **kw)

    def check(label, bt, slot, p):
        want = K.partition_rows_ref(bt, slot, p)
        nt, c = int(want.info[3]), int(want.slot_start[p])
        rank = torch.full((bt.capacity,), -1, dtype=torch.int32, device=dev)
        members = want.rowlist[:c].long()
        rank[members] = (torch.arange(c, device=dev)
                         - want.slot_start[slot[members].long()]).to(torch.int32)
        info = torch.tensor([0, 0, c, nt], dtype=torch.int32, device=dev)
        got = K.partition_rows(bt, slot, p)
        torch.cuda.synchronize()
        same_bits(torch, [got.rowlist, got.slot_start, got.timers[:nt], got.info, got.rows,
                          got.rank],
                  [want.rowlist, want.slot_start, want.timers, info, want.rows, rank])
        res["checks"] += 1
        return c, nt

    for bsz in (1, 33, 2048, 2049, 32768):
        for p in (1, 33, 1024):
            c, nt = check("mixed", *batch_of(bsz, p), p)
            print(f"kernel check row lists B={bsz} P={p}: {c} member rows, {nt} TIMER rows: "
                  "exact", flush=True)
    for bsz in (1, 33, 2049, 32768):
        for label, kw in (("all TIMER", dict(timer=1.0, valid=1.0, oob=0.0)),
                          ("no TIMER", dict(timer=0.0)), ("all invalid", dict(valid=0.0))):
            c, nt = check(label, *batch_of(bsz, 1024, **kw), 1024)
            print(f"kernel check row lists {label} B={bsz} P=1024: {c} member rows, {nt} TIMER "
                  "rows: exact", flush=True)

    p = 1024
    for label, (bt, slot) in rows_timing_batches(torch, dev, p).items():
        member = bt.valid & (bt.kind == 0) & (slot >= 0) & (slot < p)
        skey = torch.where(member, slot, torch.where(bt.valid & (bt.kind == 2), p, p + 1))
        r = three_times(torch, lambda: K.partition_rows(bt, slot, p), 100, ROWS_KERNEL_NAMES)
        r["library"] = three_times(torch, lambda: torch.sort(skey, stable=True), 100, None)
        r["plain_ms"] = time_once(torch, lambda: K.partition_rows_ref(bt, slot, p))
        n_tim = int((bt.valid & (bt.kind == 2)).sum())
        bsz = bt.capacity
        r["bound_ms"] = (bsz * (1 + 1 + 4) + bsz * (4 + 4) + 4 * (p + 1) + 4 * p + 4 * n_tim
                         + 16) / MEM_BYTES_PER_S * 1e3
        res[label] = r
        print(f"kernel partition_rows {label} P={p}: ms={r['ms']:.4f} "
              f"device_ms={r['device_ms']:.4f} kernel_ms={fmt(r['kernel_ms'])}; stable torch.sort "
              f"{r['library']['ms']:.4f}/{r['library']['device_ms']:.4f}/"
              f"{fmt(r['library']['kernel_ms'])}; plain {r['plain_ms']:.4f}; "
              f"bound {r['bound_ms']:.7f}", flush=True)
    return {"row_lists_times": res}


def subnormal_kernel_phase(torch, dev) -> dict:
    """Float32 subnormals (compared as zeros, as XLA compares them) through
    the table kernels against their plain versions on the card, bit for
    bit: K22's index build and probe over float keys of ±0.0, every
    subnormal class of both signs, NaN and a few values, C 33/2,049/10,000
    (one block and the grid sort); K21's insert with a float primary key,
    by the index and by the table scan; K23's `==`, `>` and `<=` conditions
    over those keys as writer, delete and `in` masks; and float arithmetic
    over those keys in table programs (XLA's: subnormal operands and results
    as zeros, csrc/common.cuh): K23's `T.k * 10000000000.0 > k` and
    `T.k - k < T.k / 3.0`, K24's update `set T.k = T.k * k` and upsert
    `set T.k = T.k + k, T.v = T.v` (csrc/prog.cuh t_arith). The plain
    versions run on CPU copies (the card's torch.sort places NaN
    otherwise)."""
    from siddhi_tpu_torch.compiler.siddhi_compiler import SiddhiCompiler
    from siddhi_tpu_torch.core.event import StreamSchema
    from siddhi_tpu_torch.core.executor import TS_ATTR, Env
    from siddhi_tpu_torch.core.table import (
        InMemoryTable,
        build_scan_programs,
        emit_program,
        eval_regs,
        output_scope,
    )
    from siddhi_tpu_torch.core.types import AttrType, InternTable
    from siddhi_tpu_torch.ops import table as K
    from siddhi_tpu_torch.query_api.execution import UpdateSetAttribute
    from siddhi_tpu_torch.query_api.expression import Variable

    rng = np.random.default_rng(1913)
    vals = np.concatenate([ARITH_TRAPS, np.array([np.nan, 1.0, -2.5, 1.2e-38], np.float32)])
    interner = InternTable()
    out_schema = StreamSchema("__out__", [("k", AttrType.FLOAT), ("v", AttrType.LONG)])
    checks = {"table_index_build": 0, "table_index_probe": 0, "table_write": 0,
              "table_match": 0, "table_scan": 0}

    def exact(name, got, want, nan_payloads=False):
        torch.cuda.synchronize()
        (same_bits_but_nan if nan_payloads else same_bits)(torch, to_cpu(got), want)
        checks[name] += 1

    def env_of(cols, ts, d):
        env = {("__out__", None, n): v.to(d) for n, v in cols.items()}
        env[("__out__", None, TS_ATTR)] = ts.to(d)
        return Env(env, now=torch.zeros((), dtype=torch.int64, device=d))

    for c, b in ((33, 33), (2049, 513), (10_000, 4097)):
        app = SiddhiCompiler.parse("@PrimaryKey('k') @Index('k') define table T (k float, "
                                   "v long);")
        t = InMemoryTable(app.table_definitions["T"], interner, dev, capacity=c)
        keys = torch.from_numpy(rng.choice(vals, c)).to(dev)
        valid = torch.from_numpy(rng.random(c) < 0.7).to(dev)
        exact("table_index_build", K.table_index_build(keys, valid),
              K.table_index_build_ref(keys.cpu(), valid.cpu()))
        order, sk, dups = K.table_index_build_ref(keys.cpu(), valid.cpu())
        probe = torch.from_numpy(rng.choice(vals, b)).to(dev)
        ok = torch.from_numpy(rng.random(b) < 0.9).to(dev) & ~torch.isnan(probe)
        exact("table_index_probe",
              K.table_index_probe(keys, valid, order.to(dev), sk.to(dev), probe, ok,
                                  K.winner_scratch(dev, c)),
              K.table_index_probe_ref(keys.cpu(), valid.cpu(), order, sk, probe.cpu(), ok.cpu()))
        st = t.init_state()
        st["cols"]["k"], st["valid"] = keys, valid
        st["cols"]["v"] = torch.arange(c, dtype=torch.int64, device=dev)
        st["seq"] = torch.where(valid, torch.arange(c, device=dev), torch.iinfo(torch.int64).max)
        st["next"] = torch.tensor(c, dtype=torch.int64, device=dev)
        st.update({"ix_order.k": order.to(dev), "ix_sorted.k": sk.to(dev),
                   "ix_dups.k": dups.to(dev)})
        cols = {"k": probe, "v": torch.arange(b, dtype=torch.int64, device=dev)}
        ts = torch.arange(b, dtype=torch.int64, device=dev) + 1_800_000_000_000
        rows = torch.from_numpy(rng.random(b) < 0.95).to(dev)
        for index in ((st["ix_order.k"], st["ix_sorted.k"]), None):
            exact("table_write", K.table_write(st, cols, ts, rows, ["k"], index),
                  K.table_write_ref(to_cpu(st), to_cpu(cols), ts.cpu(), rows.cpu(), ["k"]))
        for text, mode in (("T.k == k", K.MODE_WRITER), ("T.k > k", K.MODE_DELETE),
                           ("T.k <= k", K.MODE_IN),
                           ("T.k * 10000000000.0 > k", K.MODE_WRITER),
                           ("T.k - k < T.k / 3.0", K.MODE_IN)):
            scope = output_scope(t, out_schema, interner, dev)
            prog = emit_program(SiddhiCompiler.parse_expression(text), scope, "T")
            regs = eval_regs(prog.regs, env_of(cols, ts, dev), b)
            lanes = K.lane_tensors(prog, st["cols"], st["ts"])
            exact("table_match", K.table_match(prog, regs, lanes, st["valid"], rows, mode),
                  K.table_match_ref(prog, to_cpu(regs), to_cpu(lanes), valid.cpu(), rows.cpu(),
                                    mode))
        # K24: float arithmetic in the set clauses, a sequential update and
        # an upsert
        for on, sets, upsert in (("T.v == v", [("k", "T.k * k")], False),
                                 ("T.k == k", [("k", "T.k + k"), ("v", "T.v")], True)):
            scope = output_scope(t, out_schema, interner, dev)
            sp = build_scan_programs(
                t, scope, SiddhiCompiler.parse_expression(on),
                [UpdateSetAttribute(Variable(n), SiddhiCompiler.parse_expression(x))
                 for n, x in sets], [n for n, _x in sets], None)
            regs = eval_regs(sp.on.regs, env_of(cols, ts, dev), b)
            # a NaN out of the arithmetic: the host's payload and the card's differ
            if upsert:
                exact("table_scan", K.table_upsert_scan(sp, regs, st, rows, cols, ts),
                      K.table_upsert_scan_ref(sp, to_cpu(regs), to_cpu(st), rows.cpu(),
                                              to_cpu(cols), ts.cpu()), nan_payloads=True)
            else:
                exact("table_scan", K.table_update_scan(sp, regs, st, rows),
                      K.table_update_scan_ref(sp, to_cpu(regs), to_cpu(st), rows.cpu()),
                      nan_payloads=True)
        print(f"kernel check subnormal keys C={c} B={b}: K22 build and probe, K21 by the index "
              "and the scan, K23 ==, >, <= and two arithmetic conditions (writer, delete, in), "
              "K24 arithmetic set clauses (update, upsert): exact", flush=True)
    return {"subnormal_checks": checks}


SUB_VALUES = [0.0, 1e-40, -1e-40, 1e-38, 2e-45, 1.0, -0.0, float("nan"), -2e-45, 3.5]
SUB_HEAD = "define stream S (k float, v int, g int);\ndefine stream U (k float, v int);\n"
# label: (app, sends after S's events, store query, a kernel the app must launch)
SUB_APPS = {
    "filter": ("from S[k == 0.0] select k, v insert into Out;\n"
               "from S[k > 0.0] select k, v insert into Out;", [], None, None),
    "pk table": ("@PrimaryKey('k') define table T (k float, v int);\n"
                 "from S select k, v insert into T;", [], "from T select k, v", "table_write"),
    "index update": ("@Index('k') define table T (k float, v int);\n"
                     "from S select k, v insert into T;\n"
                     "from U update T set T.v = v on T.k == k;", [("U", (0.0, 99))],
                     "from T select k, v", "table_index_build"),
    "dense update": ("define table T (k float, v int);\nfrom S select k, v insert into T;\n"
                     "from U update T set T.v = v on T.k == k;", [("U", (-1e-40, 98))],
                     "from T select k, v", "table_match"),
    "upsert": ("define table T (k float, v int);\nfrom S select k, v insert into T;\n"
               "from U update or insert into T set T.v = v on T.k == k;",
               [("U", (2e-45, 97)), ("U", (7.0, 96))], "from T select k, v", "table_scan"),
    "in table": ("define table T (k float, v int);\nfrom U insert into T;\n"
                 "from S[(T.k == k) in T] select k, v insert into Out;", [], None, "table_match"),
    "sort window": ("from S#window.sort(2, k, 'asc') select k, v insert all events into Out;",
                    [], None, "sort_window_step"),
    "pattern": ("from every e1=S[k == 0.0] -> e2=S[k > e1.k] select e1.v as a, e2.v as b "
                "insert into Out;", [], None, "pattern_advance"),
    "scan pattern": ("from every e1=S[k == 0.0] -> e2=S[k > e1.k] or e3=S[k < e1.k] "
                     "select e1.v as a, e2.v as b, e3.v as c insert into Out;", [], None,
                     "pattern_scan"),
    "join on": ("from S#window.length(10) join U#window.length(10) on S.k == U.k "
                "select S.v as a, U.v as b insert into Out;",
                [("U", (x, 100 + i)) for i, x in enumerate(SUB_VALUES)], None, "join_assemble"),
    "distinctCount": ("from S#window.length(8) select distinctCount(k) as d insert into Out;",
                      [], None, "distinct_count"),
    "partitioned sort": ("partition with (g of S) begin from S#window.sort(2, k, 'asc') "
                         "select k, v insert all events into Out; end;", [], None,
                         "partition_sort_window_step"),
    "partitioned scan pattern": ("partition with (g of S) begin from every e1=S[k == 0.0] -> "
                                 "e2=S[k > e1.k] or e3=S[k < e1.k] select e1.v as a, e2.v as b "
                                 "insert into Out; end;", [], None, "partition_pattern_scan"),
    # float32 arithmetic: subnormal operands and results as zeros (PR 20)
    "product filter": ("from S[k * 10000000000.0 > 0.0] select k, v insert into Out;", [], None,
                       None),
    "sum, avg having": ("from S#window.length(4) select sum(k) as s, avg(k) as a having s > 0.0 "
                        "insert into Out;", [], None, "running_sum"),
    "min, max": ("from S select min(k) as mn, max(k) as mx insert into Out;", [], None,
                 "running_extreme"),
    "windowed min, max, stdDev": ("from S#window.length(3) select min(k) as mn, max(k) as mx, "
                                  "stdDev(k) as sd insert into Out;", [], None, "window_extreme"),
    "grouped sum, min": ("from S select g, sum(k) as s, min(k) as m group by g insert into Out;",
                         [], None, "keyed_running_sum"),
    "projections": ("from S select k * 1e10 as a, k / 3.0 as b, k - 1e-38 as c, k % 1.0 as d, "
                    "k % 3.0 as e, maximum(k, 0.0) as f, minimum(k, 0.0, 1.0) as h "
                    "insert into Out;", [], None, None),
    "upsert product": ("define table T (k float, v int);\nfrom S select k, v insert into T;\n"
                       "from U update or insert into T set T.k = T.k * k on T.v == v;",
                       [("U", (1e-20, 5)), ("U", (1e10, 2)), ("U", (1e-30, 9))],
                       "from T select k, v", "table_scan"),
    "scan pattern product": ("from every e1=S[k >= 0.0] -> e2=S[k > e1.k * 100.0] or "
                             "e3=S[k < 0.0] select e1.v as a, e2.v as b, e3.v as c "
                             "insert into Out;", [], None, "pattern_scan"),
    "partitioned sum having": ("partition with (g of S) begin from S#window.length(4) "
                               "select g, sum(k) as s having s > 0.0 insert into Out; end;", [],
                               None, "keyed_running_sum"),
    "partitioned windowed min, max": ("partition with (g of S) begin from S#window.length(3) "
                                      "select g, min(k) as m, max(k) as x insert into Out; end;",
                                      [], None, "partition_window_extreme"),
}


def run_sub_app(dev: str, app: str, sends: list, query) -> tuple:
    from siddhi_tpu_torch import SiddhiManager

    rt = SiddhiManager(device=dev).create_siddhi_app_runtime(SUB_HEAD + app)
    out = []
    if "Out" in rt.junctions:
        rt.add_callback("Out", lambda evs: out.extend(tuple(e.data) for e in evs))
    rt.start()
    if "U" in app and "from U insert into T" in app:
        rt.get_input_handler("U").send((0.0, 1))
    for i, x in enumerate(SUB_VALUES):
        rt.get_input_handler("S").send((x, i, i % 2))
    for stream, row in sends:
        rt.get_input_handler(stream).send(row)
    rows = [r[1] for r in rt.query(query)] if query else None
    rt.shutdown()
    return repr(out), repr(rows)


def subnormal_path_phase(torch) -> dict:
    """The subnormal apps (SUB_APPS: filters, table keys, updates and `in`
    conditions, sort windows, patterns on both routes, a join `on`,
    distinctCount, in and out of partitions; float32 arithmetic in filters,
    projections, sums, averages, stdDev, min/max, a table's set clause and
    a pattern's condition) on the card, one event a send, against
    device="cpu": every row equal, in order; each app launches the kernel
    named beside it."""
    from siddhi_tpu_torch import kernels

    res = {}
    for label, (app, sends, query, kernel) in SUB_APPS.items():
        kernels.launches.clear()
        got = run_sub_app("cuda", app, sends, query)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        want = run_sub_app("cpu", app, sends, query)
        if got != want:
            raise AssertionError(f"subnormal app {label}: card {got} vs cpu {want}")
        if kernel is not None and not launches.get(kernel):
            raise AssertionError(f"subnormal app {label}: {kernel} never launched ({launches})")
        res[label] = launches.get(kernel, 0) if kernel else 0
        print(f"path SUB {label}: rows = device=\"cpu\"; {kernel} launches {res[label]}",
              flush=True)
    return res


# two repaired faults: float to int as XLA converts, and a
# partitioned batch window's sums leaking past a RESET as the JAX package's
CONVERT_VALUES = [float("nan"), float("inf"), float("-inf"), 3e9, -3e9, 1e19, -1e19, 2.0**31,
                  -(2.0**31), 2.0**63, -(2.0**63), 2147483520.0, 9.2233715e18, 0.0, -0.0, 1e-40,
                  -1e-40, 0.5, -0.5, 2.9, -2.9, 123456.78]
CONVERT_HEAD = "define stream S (f float, d double, i int);\n"
CONVERT_APPS = {
    "four events": CONVERT_HEAD + "from S select i, convert(f, 'int') as a, convert(d, 'long') "
                                  "as b insert into Out;",
    "filter": CONVERT_HEAD + "from S[convert(f, 'int') > 0] select i insert into Out;",
    "sum": CONVERT_HEAD + "from S select i, sum(convert(f, 'int')) as s insert into Out;",
    "script": CONVERT_HEAD + "define function toLong[python] return long { return data[0] };\n"
                             "from S select i, toLong(f) as a insert into Out;",
    "table": CONVERT_HEAD + "define table T (a int, b long, i int);\nfrom S select convert(f, "
                            "'int') as a, cast(d, 'long') as b, i insert into T;",
}
LEAK_HEAD = ("@app:playback @app:batch(size='{batch}') @app:partitionCapacity(size='64')\n"
             "define stream S (sym string, p float, v int, ets long);\n")
LEAK_APPS = {
    "lengthBatch sum/count": "from S#window.lengthBatch(2) select sym, sum(p) as s, count() as n "
                             "insert into Out;",
    "lengthBatch avg, all events": "from S#window.lengthBatch(3) select sym, avg(p) as a, "
                                   "sum(v) as t insert all events into Out;",
    "lengthBatch having": "from S#window.lengthBatch(2) select sym, sum(p) as s having s > 2.5 "
                          "insert into Out;",
    "externalTimeBatch": "from S#window.externalTimeBatch(ets, 20 milliseconds) select sym, "
                         "sum(p) as s, avg(p) as a insert all events into Out;",
}


def fault_repair_phase(torch) -> dict:
    """Two repaired faults on the card. The conversion: `convert_to` over
    CONVERT_VALUES on the card against the host, bit for bit; K24's set
    values through `csrc/prog.cuh` `convert` (`set T.a = f, T.b = f`, a
    float into int and long lanes, the update's and the key groups'
    upsert's) against their plain versions; the CONVERT_APPS on the card
    against device="cpu". The leak: the LEAK_APPS (partitioned batch
    windows, 24 symbols; timeBatch's TIMER steps would take minutes here, the
    CPU tests hold it against JAX) at batch 16 and 33 on the card against
    device="cpu", rows equal in order (NaN as NaN), each launching K8
    (`keyed_running_sum`). The prices are NaN, +inf and multiples of 1e8,
    whose sums are exact in any order: K8 adds a key's rows in another
    order than the plain running sum (they agree within RTOL), and 1e8
    beside small values rounds apart by order."""
    from siddhi_tpu_torch import SiddhiManager, kernels
    from siddhi_tpu_torch.compiler.siddhi_compiler import SiddhiCompiler
    from siddhi_tpu_torch.core.event import StreamSchema
    from siddhi_tpu_torch.core.executor import TS_ATTR, Env
    from siddhi_tpu_torch.core.table import (InMemoryTable, build_scan_programs, eval_regs,
                                              output_scope)
    from siddhi_tpu_torch.core.types import AttrType, InternTable, convert_to
    from siddhi_tpu_torch.ops import table as K
    from siddhi_tpu_torch.query_api.execution import UpdateSetAttribute
    from siddhi_tpu_torch.query_api.expression import Variable

    dev = "cuda"
    checks = 0
    x = torch.tensor(CONVERT_VALUES, dtype=torch.float32)
    for dt in (torch.int32, torch.int64):
        got = convert_to(x.to(dev), dt).cpu()
        if not torch.equal(got, convert_to(x, dt)):
            raise AssertionError(f"convert_to {dt} on the card: {got.tolist()}")
        checks += 1
    # K24's set values: a float into an int and a long lane
    n = len(CONVERT_VALUES)
    interner = InternTable()
    table = InMemoryTable(SiddhiCompiler.parse("define table T (k long, a int, b long);")
                          .table_definitions["T"], interner, dev, capacity=2 * n)
    scope = output_scope(table, StreamSchema("__out__", [("k", AttrType.LONG),
                                                          ("f", AttrType.FLOAT)]), interner, dev)
    sets = [UpdateSetAttribute(Variable(c), SiddhiCompiler.parse_expression("f")) for c in "ab"]
    for upsert in (False, True):
        sp = build_scan_programs(table, scope, SiddhiCompiler.parse_expression("T.k == k"), sets,
                                 ["a", "b"])
        st = table.init_state()
        st["cols"]["k"] = torch.arange(2 * n, dtype=torch.int64, device=dev)
        st["valid"] = torch.arange(2 * n, device=dev) < n
        st["seq"] = torch.arange(2 * n, dtype=torch.int64, device=dev)
        st["next"] = torch.tensor(n, dtype=torch.int64, device=dev)
        cols = {"k": torch.arange(n, dtype=torch.int64, device=dev), "f": x.to(dev)}
        ts = torch.arange(n, dtype=torch.int64, device=dev)
        env = {("__out__", None, c): v for c, v in cols.items()}
        env[("__out__", None, TS_ATTR)] = ts
        regs = eval_regs(sp.on.regs, Env(env, now=torch.zeros((), dtype=torch.int64,
                                                               device=dev)), n)
        rows = torch.ones(n, dtype=torch.bool, device=dev)
        if upsert:
            ins = {"k": cols["k"], "a": convert_to(cols["f"], torch.int32),
                   "b": convert_to(cols["f"], torch.int64)}
            got = K.table_upsert_scan(sp, regs, st, rows, ins, ts)
            want = K.table_upsert_scan_ref(sp, regs, st, rows, ins, ts)
        else:
            got = K.table_update_scan(sp, regs, st, rows)
            want = K.table_update_scan_ref(sp, regs, st, rows)
        same_bits(torch, got, want)
        checks += 1
    print(f"fault check conversion: convert_to and K24's set values (prog.cuh convert) over "
          f"{n} values = plain, bit for bit ({checks} checks)", flush=True)
    res = {"conversion_checks": checks}

    def run(dev, app, rows, chunk):
        rt = SiddhiManager(device=dev).create_siddhi_app_runtime(app)
        out = []
        if "Out" in rt.junctions:
            rt.add_callback("Out", lambda evs: out.extend(tuple(e.data) for e in evs))
        rt.start()
        h = rt.get_input_handler("S")
        for lo in range(0, len(rows), chunk):
            part = rows[lo:lo + chunk]
            if chunk == 1:
                h.send(part[0])
            else:
                h.send_many(part, [r[3] for r in part])
        table = [r[1] for r in rt.query("from T select a, b, i")] if "table T" in app else None
        rt.shutdown()
        return repr(out).replace("nan", "NaN"), repr(table)

    sends = [(v, v, i) for i, v in enumerate(CONVERT_VALUES)]
    for label, app in CONVERT_APPS.items():
        if run("cuda", app, sends, 1) != run("cpu", app, sends, 1):
            raise AssertionError(f"conversion app {label}: card rows differ from the cpu's")
        print(f"fault check conversion app {label}: rows = device=\"cpu\"", flush=True)
    rng = np.random.default_rng(2121)
    pool = [float("nan"), float("inf"), 1e8, 2e8, 3e8]
    rows = [(f"K{int(rng.integers(0, 24))}", float(rng.choice(pool)), int(rng.integers(1, 5)),
             100 + 3 * i) for i in range(240)]
    res["leak_launches"] = {}
    for label, body in LEAK_APPS.items():
        for batch in (16, 33):
            app = LEAK_HEAD.format(batch=batch) + f"partition with (sym of S) begin\n{body}\nend;"
            kernels.launches.clear()
            got = run("cuda", app, rows, 50)
            torch.cuda.synchronize()
            launches = kernels.launches.get("keyed_running_sum", 0)
            want = run("cpu", app, rows, 50)
            if got != want:
                at = next(i for i, (x, y) in enumerate(zip(got[0], want[0])) if x != y)
                raise AssertionError(f"leak app {label} at batch {batch}: card rows differ from "
                                     f"character {at}: {got[0][at - 80:at + 80]} vs "
                                     f"{want[0][at - 80:at + 80]}")
            if not launches:
                raise AssertionError(f"leak app {label}: keyed_running_sum never launched")
            res["leak_launches"][f"{label} B={batch}"] = launches
            print(f"fault check leak app {label} at batch {batch}: rows = device=\"cpu\"; "
                  f"keyed_running_sum launches {launches}", flush=True)
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from siddhi_tpu_torch import kernels

    t_start = time.perf_counter()

    def lap(done: str) -> None:
        print(f"elapsed {time.perf_counter() - t_start:.1f} s after {done}", flush=True)

    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)
    build_s = kernels.build_all()
    print(f"kernel build: {build_s:.2f} s for {', '.join(kernels.SOURCES)}", flush=True)
    if "--profile" in sys.argv[1:]:
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        out = {"card": card}
        for name, app, b in (("filter_window_minmax", main_app(MINMAX), MAIN_BATCH),
                             ("tumbling_groupby", GROUP_APP.format(batch=MAIN_BATCH, n=GROUP_N),
                              MAIN_BATCH),
                             ("sliding_join", SLIDING_JOIN_APP, JOIN_BATCH),
                             ("pattern_2state", PATTERN_APP.format(batch=MAIN_BATCH), MAIN_BATCH),
                             ("count_sequence", COUNT_APP.format(batch=MAIN_BATCH), MAIN_BATCH),
                             ("logical_pattern", LOGICAL_APP.format(batch=MAIN_BATCH),
                              MAIN_BATCH),
                             ("external_time_batch", XB_APP.format(batch=TB_BATCH), TB_BATCH)):
            print(f"profile: {name}", flush=True)
            out[name] = {"per_batch": profile_phase(torch, app, b),
                         "fused": profile_fused(torch, app, b)}
        print("profile: time join", flush=True)
        out["time_join"] = profile_timers(torch, TIME_JOIN_APP, JOIN_BATCH)
        print("profile: absent pattern", flush=True)
        out["absent_pattern"] = profile_timers(torch, ABSENT_APP.format(batch=MAIN_BATCH),
                                               MAIN_BATCH, "absent pattern")
        print("profile: time batch", flush=True)
        out["time_batch"] = profile_timers(torch, TB_APP.format(batch=TB_BATCH), 1000,
                                           "time batch (one 1,000-event bucket a call)")
        with open(os.path.join(ROOT, "chiprun_out", "profile.json"), "w") as f:
            json.dump(out, f, indent=1)
        return 0

    if "--partition" in sys.argv[1:]:
        partition_kernel_phase(torch, "cuda")
        partition_windows_kernel_phase(torch, "cuda")
        partition_pattern_kernel_phase(torch, "cuda")
        partition_join_kernel_phase(torch, "cuda")
        partition_special_kernel_phase(torch, "cuda")
        partition_path_phase(torch)
        partition_windows_path_phase(torch)
        partition_pattern_path_phase(torch)
        partition_join_path_phase(torch)
        partition_special_path_phase(torch)
        return 0
    if "--partition-kernels" in sys.argv[1:]:
        partition_kernel_phase(torch, "cuda")
        partition_windows_kernel_phase(torch, "cuda")
        partition_pattern_kernel_phase(torch, "cuda")
        partition_join_kernel_phase(torch, "cuda")
        partition_special_kernel_phase(torch, "cuda")
        return 0
    if "--aggregation" in sys.argv[1:]:
        aggregation_kernel_phase(torch, "cuda")
        lap("aggregation_kernel_phase")
        if "--no-paths" not in sys.argv[1:]:
            aggregation_path_phase(torch)
            lap("paths AGG and AGJ")
        return 0
    if "--partition-patterns" in sys.argv[1:]:
        partition_pattern_kernel_phase(torch, "cuda")
        if "--no-paths" not in sys.argv[1:]:
            partition_pattern_path_phase(torch)
        return 0
    if "--named-windows" in sys.argv[1:]:
        named_window_kernel_phase(torch, "cuda")
        lap("named_window_kernel_phase")
        if "--no-paths" not in sys.argv[1:]:
            named_window_path_phase(torch)
            lap("path NW")
        return 0
    if "--lineage" in sys.argv[1:]:
        lineage_kernel_phase(torch, "cuda")
        lap("lineage_kernel_phase")
        if "--no-paths" not in sys.argv[1:]:
            lineage_path_phase(torch)
            lap("path LIN")
        return 0
    if "--sorts" in sys.argv[1:]:
        res = named_window_kernel_phase(torch, "cuda", kernel_sums=True)
        lap("named_window_kernel_phase")
        res.update(table_kernel_phase(torch, "cuda", index_only=True))
        lap("table_kernel_phase (K22 alone)")
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "sorts.json"), "w") as f:
            json.dump({"card": card, "kernels": {k: res[k] for k in SORT_KERNELS}}, f, indent=1)
        return 0
    if "--shard" in sys.argv[1:]:
        shard_kernel_phase(torch, "cuda")
        lap("shard_kernel_phase")
        if "--no-paths" not in sys.argv[1:]:
            shard_path_phase(torch)
            lap("path SH")
        return 0
    if "--redesign" in sys.argv[1:]:
        out = {"card": card}
        for phase in (ring_view_kernel_phase, row_lists_kernel_phase, subnormal_kernel_phase):
            out.update(phase(torch, "cuda"))
            lap(phase.__name__)
        if "--no-paths" not in sys.argv[1:]:
            out["subnormal_path"] = subnormal_path_phase(torch)
            lap("path SUB")
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "redesign.json"), "w") as f:
            json.dump(out, f, indent=1)
        return 0
    if "--faults" in sys.argv[1:]:
        fault_repair_phase(torch)
        lap("fault_repair_phase")
        return 0
    if "--partition-joins" in sys.argv[1:]:
        partition_join_kernel_phase(torch, "cuda")
        lap("partition_join_kernel_phase")
        if "--no-paths" not in sys.argv[1:]:
            partition_join_path_phase(torch)
            lap("paths PJ, PSW and PFQ")
        return 0
    lap("the build")
    res = {}
    for phase in (kernel_phase, fused_kernel_phase, grouped_kernel_phase, join_kernel_phase,
                  pattern_kernel_phase, pattern_scan_kernel_phase, time_batch_kernel_phase,
                  table_kernel_phase, special_window_kernel_phase, partition_kernel_phase,
                  partition_windows_kernel_phase, partition_pattern_kernel_phase,
                  partition_join_kernel_phase, partition_special_kernel_phase,
                  aggregation_kernel_phase, named_window_kernel_phase, lineage_kernel_phase,
                  shard_kernel_phase):
        res.update(phase(torch, "cuda"))
        lap(phase.__name__)
    redesign = {}  # K11/K48 and the row lists three ways; the subnormal checks
    for phase in (ring_view_kernel_phase, row_lists_kernel_phase, subnormal_kernel_phase):
        redesign.update(phase(torch, "cuda"))
        lap(phase.__name__)
    if "--kernels" in sys.argv[1:]:
        return 0
    verify_phase("cuda")
    lap("verify_phase")
    main = main_path_phase(torch)
    grouped = grouped_path_phase(torch)
    lap("the quickstart and tumbling_groupby paths")
    joined = join_path_phase(torch)
    time_join = time_join_path_phase(torch)
    time_agg = time_agg_path_phase(torch)
    lap("paths J, T and T2")
    pattern_p = pattern_path_phase(
        torch, "P pattern_2state", PATTERN_APP.format(batch=MAIN_BATCH), PATTERN_EVENTS,
        {"pattern_advance": 2 * (MAIN_BATCH // PATTERN_C), "pattern_emit": MAIN_BATCH // PATTERN_C})
    pattern_c = pattern_path_phase(
        torch, "C count_sequence", COUNT_APP.format(batch=MAIN_BATCH), COUNT_EVENTS,
        {"pattern_count": MAIN_BATCH // COUNT_C, "pattern_emit": MAIN_BATCH // COUNT_C})
    lap("paths P and C")
    logical = logical_path_phase(torch)
    absent = absent_path_phase(torch)
    lap("paths L and A")
    time_batch = tb_path_phase(torch)
    external_time_batch = xb_path_phase(torch)
    lap("paths TB and XB")
    tables = table_paths_phase(torch)
    lap("the table paths")
    special = {k: special_path_phase(torch, k) for k in ("SW", "FQ", "LF")}
    special["CR"] = cron_path_phase(torch)
    special["FN"] = fn_path_phase(torch)
    lap("the special paths")
    partitioned = partition_path_phase(torch)
    partition_windows = partition_windows_path_phase(torch)
    lap("paths PT, PTE, PTB and PTT")
    partition_patterns = partition_pattern_path_phase(torch)
    lap("paths PPF, PPC and PPA")
    partition_joins = partition_join_path_phase(torch)
    lap("paths PJ, PSW and PFQ")
    partition_specials = partition_special_path_phase(torch)
    lap("paths PLF and PCR")
    aggregations = aggregation_path_phase(torch)
    lap("paths AGG and AGJ")
    named_windows = named_window_path_phase(torch)
    lap("path NW")
    lineage = lineage_path_phase(torch)
    lap("path LIN")
    sharded = shard_path_phase(torch)
    lap("path SH")
    redesign["subnormal_path"] = subnormal_path_phase(torch)
    lap("path SUB")
    redesign["fault_repairs"] = fault_repair_phase(torch)
    lap("fault_repair_phase")

    src = {"length_window_step": ("siddhi_tpu_torch/csrc/length_window.cu",
                                  "siddhi_tpu/core/windows.py:352"),
           "running_sum": ("siddhi_tpu_torch/csrc/running_sum.cu",
                           "siddhi_tpu/ops/prefix.py:51"),
           "window_extreme": ("siddhi_tpu_torch/csrc/window_extreme.cu",
                              "siddhi_tpu/core/aggregators.py:191"),
           "wire_decode": ("siddhi_tpu_torch/csrc/wire_decode.cu",
                           "siddhi_tpu/core/wire.py:665"),
           "deliver_pack": ("siddhi_tpu_torch/csrc/deliver_pack.cu",
                            "siddhi_tpu/core/ingest.py:488"),
           "batch_window_step": ("siddhi_tpu_torch/csrc/batch_window.cu",
                                 "siddhi_tpu/core/windows.py:553"),
           "assign_slots": ("siddhi_tpu_torch/csrc/group_assign.cu",
                            "siddhi_tpu/ops/group.py:85"),
           "keyed_running_sum": ("siddhi_tpu_torch/csrc/keyed_running_sum.cu",
                                 "siddhi_tpu/ops/group.py:205"),
           "keep_last": ("siddhi_tpu_torch/csrc/keep_last.cu",
                         "siddhi_tpu/ops/group.py:278"),
           "time_window_step": ("siddhi_tpu_torch/csrc/time_window.cu",
                                "siddhi_tpu/core/windows.py:190"),
           "ring_view": ("siddhi_tpu_torch/csrc/ring_view.cu",
                         "siddhi_tpu/core/windows.py:438"),
           "join_assemble": ("siddhi_tpu_torch/csrc/join_probe.cu",
                             "siddhi_tpu/core/join.py:311"),
           "pattern_advance": ("siddhi_tpu_torch/csrc/pattern_advance.cu",
                               "siddhi_tpu/core/pattern.py:1754"),
           "pattern_count": ("siddhi_tpu_torch/csrc/pattern_count.cu",
                             "siddhi_tpu/core/pattern.py:1381"),
           "pattern_emit": ("siddhi_tpu_torch/csrc/pattern_emit.cu",
                            "siddhi_tpu/core/pattern.py:1864"),
           "pattern_scan": ("siddhi_tpu_torch/csrc/pattern_scan.cu",
                            "siddhi_tpu/core/pattern.py:566"),
           "time_batch_step": ("siddhi_tpu_torch/csrc/batch_window.cu",
                               "siddhi_tpu/core/windows.py:589"),
           "running_extreme": ("siddhi_tpu_torch/csrc/running_extreme.cu",
                               "siddhi_tpu/ops/prefix.py:71"),
           "keyed_running_extreme": ("siddhi_tpu_torch/csrc/running_extreme.cu",
                                     "siddhi_tpu/ops/group.py:241"),
           "window_extreme_keyed": ("siddhi_tpu_torch/csrc/window_extreme.cu",
                                    "siddhi_tpu/core/aggregators.py:196"),
           "distinct_count": ("siddhi_tpu_torch/csrc/distinct_count.cu",
                              "siddhi_tpu/core/aggregators.py:229"),
           "table_write": ("siddhi_tpu_torch/csrc/table_write.cu",
                           "siddhi_tpu/core/table.py:364"),
           "table_index_build": ("siddhi_tpu_torch/csrc/table_index.cu",
                                 "siddhi_tpu/core/table.py:337"),
           "table_index_probe": ("siddhi_tpu_torch/csrc/table_index.cu",
                                 "siddhi_tpu/core/table.py:606"),
           "table_match": ("siddhi_tpu_torch/csrc/table_match.cu",
                           "siddhi_tpu/core/table.py:431"),
           "table_scan": ("siddhi_tpu_torch/csrc/table_scan.cu",
                          "siddhi_tpu/core/table.py:704"),
           "sort_window_step": ("siddhi_tpu_torch/csrc/special_window.cu",
                                "siddhi_tpu/core/windows_special.py:160"),
           "frequent_window_step": ("siddhi_tpu_torch/csrc/special_window.cu",
                                    "siddhi_tpu/core/windows_special.py:424"),
           "lossy_frequent_window_step": ("siddhi_tpu_torch/csrc/special_window.cu",
                                          "siddhi_tpu/core/windows_special.py:543"),
           "cron_window_step": ("siddhi_tpu_torch/csrc/special_window.cu",
                                "siddhi_tpu/core/windows_special.py:298"),
           "partition_length_window_step": ("siddhi_tpu_torch/csrc/partition_window.cu",
                                            "siddhi_tpu/core/partition.py:105"),
           "partition_window_extreme": ("siddhi_tpu_torch/csrc/partition_window.cu",
                                        "siddhi_tpu/core/aggregators.py:191"),
           "partition_time_window_step": ("siddhi_tpu_torch/csrc/partition_time.cu",
                                          "siddhi_tpu/core/windows.py:190"),
           "partition_batch_window_step": ("siddhi_tpu_torch/csrc/partition_batch.cu",
                                           "siddhi_tpu/core/windows.py:553"),
           "partition_assign_slots": ("siddhi_tpu_torch/csrc/group_assign.cu",
                                      "siddhi_tpu/ops/group.py:85"),
           "partition_pattern_advance": ("siddhi_tpu_torch/csrc/partition_pattern.cu",
                                         "siddhi_tpu/core/partition.py:326"),
           "partition_pattern_count": ("siddhi_tpu_torch/csrc/partition_pattern.cu",
                                       "siddhi_tpu/core/partition.py:326"),
           "partition_pattern_emit": ("siddhi_tpu_torch/csrc/partition_pattern.cu",
                                      "siddhi_tpu/core/partition.py:326"),
           "partition_pattern_scan": ("siddhi_tpu_torch/csrc/pattern_scan.cu",
                                      "siddhi_tpu/core/partition.py:378"),
           "pattern_chunks": ("siddhi_tpu_torch/csrc/partition_pattern.cu",
                              "siddhi_tpu/core/partition.py:356"),
           "pattern_place": ("siddhi_tpu_torch/csrc/partition_pattern.cu",
                             "siddhi_tpu/core/partition.py:436"),
           "partition_rows": ("siddhi_tpu_torch/csrc/partition_time.cu",
                              "siddhi_tpu/core/partition.py:356"),
           "partition_ring_view": ("siddhi_tpu_torch/csrc/partition_join.cu",
                                   "siddhi_tpu/core/windows.py:438"),
           "partition_join_assemble": ("siddhi_tpu_torch/csrc/partition_join.cu",
                                       "siddhi_tpu/core/partition.py:214"),
           "partition_sort_window_step": ("siddhi_tpu_torch/csrc/special_window.cu",
                                          "siddhi_tpu/core/windows_special.py:160"),
           "partition_frequent_window_step": ("siddhi_tpu_torch/csrc/special_window.cu",
                                              "siddhi_tpu/core/windows_special.py:424"),
           "partition_lossy_frequent_window_step": ("siddhi_tpu_torch/csrc/special_window.cu",
                                                    "siddhi_tpu/core/windows_special.py:543"),
           "partition_cron_window_step": ("siddhi_tpu_torch/csrc/special_window.cu",
                                          "siddhi_tpu/core/windows_special.py:298"),
           "agg_step": ("siddhi_tpu_torch/csrc/aggregation.cu",
                        "siddhi_tpu/core/aggregation.py:470"),
           "agg_find_merge": ("siddhi_tpu_torch/csrc/aggregation.cu",
                              "siddhi_tpu/core/aggregation.py:887"),
           "order_limit": ("siddhi_tpu_torch/csrc/order_limit.cu",
                           "siddhi_tpu/core/selector.py:261"),
           "order_limit_partitioned": ("siddhi_tpu_torch/csrc/order_limit.cu",
                                       "siddhi_tpu/core/partition.py:105"),
           "mix_keys": ("siddhi_tpu_torch/csrc/mix_keys.cu", "siddhi_tpu/ops/group.py:37"),
           "ring_view_seq": ("siddhi_tpu_torch/csrc/ring_view.cu",
                             "siddhi_tpu/core/windows.py:453"),
           "shard_owner": ("siddhi_tpu_torch/csrc/keyshard.cu",
                           "siddhi_tpu/parallel/keyshard.py:74"),
           "shard_fold": ("siddhi_tpu_torch/csrc/keyshard.cu",
                          "siddhi_tpu/parallel/keyshard.py:227"),
           "shard_route": ("siddhi_tpu_torch/csrc/shard_route.cu",
                           "siddhi_tpu/parallel/mesh.py:175")}
    # launches: K1-K5 from the quickstart path's run, K6-K9 from the
    # tumbling_groupby path's run, K10 from path T's run, K11 and K12 from
    # path J's, K13 and K15 from path P's, K14 from path C's, K16 from path
    # L's, K17, K19, K3's key lane and K20 from path TB's, K18 from path
    # XB's (each counted from 0 just before its run)
    path_of = dict.fromkeys(GROUP_KERNELS[:4], grouped["launches"])
    path_of["time_window_step"] = time_join["launches"]
    path_of["ring_view"] = path_of["join_assemble"] = joined["launches"]
    path_of["pattern_advance"] = path_of["pattern_emit"] = pattern_p["launches"]
    path_of["pattern_count"] = pattern_c["launches"]
    path_of["pattern_scan"] = logical["launches"]
    for k in ("time_batch_step", "keyed_running_extreme", "window_extreme_keyed",
              "distinct_count"):
        path_of[k] = time_batch["launches"]
    path_of["running_extreme"] = external_time_batch["launches"]
    # K21 and K22's probe from path TAB-PK's run, K22's rebuild and K24 from
    # TAB-UPSERT's, K23 from TAB-DENSE's
    path_of["table_write"] = path_of["table_index_probe"] = tables["TAB-PK"]["launches"]
    path_of["table_index_build"] = path_of["table_scan"] = tables["TAB-UPSERT"]["launches"]
    path_of["table_match"] = tables["TAB-DENSE"]["launches"]
    # K25-K28 from paths SW, FQ, LF and CR
    for label, k in SPECIAL_KERNEL_OF.items():
        path_of[k] = special[label]["launches"]
    # K29 and K30 from path PT
    path_of["partition_length_window_step"] = partitioned["launches"]
    path_of["partition_window_extreme"] = partitioned["launches"]
    # K31 from path PTE, K32 and K33 from path PTB
    path_of["partition_time_window_step"] = partition_windows["PTE"]["launches"]
    path_of["partition_batch_window_step"] = partition_windows["PTB"]["launches"]
    path_of["partition_assign_slots"] = partition_windows["PTB"]["launches"]
    # K34, K36 and the chunk lists from path PPF, K35 from PPC, K37 and the
    # placement from PPA
    for k in ("partition_pattern_advance", "partition_pattern_emit", "pattern_chunks"):
        path_of[k] = partition_patterns["PPF"]["launches"]
    path_of["partition_pattern_count"] = partition_patterns["PPC"]["launches"]
    path_of["partition_pattern_scan"] = partition_patterns["PPA"]["launches"]
    path_of["pattern_place"] = partition_patterns["PPA"]["launches"]
    path_of["partition_rows"] = partition_patterns["PPA"]["launches"]
    # K38 and K39 from path PJ, K40 from PSW, K41 from PFQ
    path_of["partition_ring_view"] = partition_joins["PJ"]["launches"]
    path_of["partition_join_assemble"] = partition_joins["PJ"]["launches"]
    path_of["partition_sort_window_step"] = partition_joins["PSW"]["launches"]
    path_of["partition_frequent_window_step"] = partition_joins["PFQ"]["launches"]
    # K42 from path PLF, K43 from PCR, K44 from AGG's ingest, K45 from AGG's
    # store queries and AGJ's probe steps
    path_of["partition_lossy_frequent_window_step"] = partition_specials["PLF"]["launches"]
    path_of["partition_cron_window_step"] = partition_specials["PCR"]["launches"]
    path_of["agg_step"] = aggregations["AGG"]["launches"]
    path_of["agg_find_merge"] = aggregations["AGJ"]["launches"]
    # K46 (both entries) and K47 from path NW
    for k in NW_KERNEL_NAMES:
        path_of[k] = named_windows["launches"]
    # K48 from path LIN's J (the lineage-armed self-join)
    path_of["ring_view_seq"] = lineage["J"]["launches"]
    # K49 (owner and fold) from path SH-KEYS, K50 from SH-ROUTED
    path_of["shard_owner"] = path_of["shard_fold"] = sharded["KEYS"]["launches"]
    path_of["shard_route"] = sharded["ROUTED"]["launches"]
    path_launches = {k: path_of.get(k, main["launches"]).get(k, 0) for k in res}
    table = [
        {"name": k, "route": "cuda", "source": src[k][0], "replaces": src[k][1],
         "launches": path_launches[k], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for k, r in res.items()
    ]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "build_s": build_s, "kernels": table,
                   "fused_kernel_shapes": {k: {"K8": res[k]["K8"], "K32": res[k]["K32"]}
                                           for k in ("wire_decode", "deliver_pack")},
                   "main_path": main["apps"], "peak_bytes": main["peak_bytes"],
                   "tumbling_groupby": grouped,
                   "keyed_running_sum_int64_ms": res["keyed_running_sum"]["int64"]["ms"],
                   "sliding_join": joined, "time_join": time_join, "time_aggregate": time_agg,
                   "join_kernel_shapes": {
                       "time_window_step": res["time_window_step"]["other_shapes_ms"],
                       "ring_view_W1024_ms": res["ring_view"]["W1024_ms"],
                       "join_assemble_T_shape_ms": res["join_assemble"]["T_shape_ms"]},
                   "pattern_2state": pattern_p, "count_sequence": pattern_c,
                   "pattern_kernel_shapes": {
                       "pattern_advance": res["pattern_advance"]["other_shapes_ms"],
                       "pattern_emit": res["pattern_emit"]["other_shapes_ms"],
                       "pattern_scan_path_A": res["pattern_scan"]["path_A_shape"]},
                   "logical_pattern": logical, "absent_pattern": absent,
                   "time_batch": time_batch, "external_time_batch": external_time_batch,
                   "time_batch_kernel_shapes": {
                       "time_batch_step_XB_ms": res["time_batch_step"]["XB_ms"],
                       "distinct_count_XB_ms": res["distinct_count"]["XB_ms"],
                       "window_extreme_keyed_pairs": res["window_extreme_keyed"]["pairs"],
                       "running_extreme_library": res["running_extreme"]["library"]},
                   "tables": tables, "special_paths": special, "partition_path": partitioned,
                   "partition_window_paths": partition_windows,
                   "partition_pattern_paths": partition_patterns,
                   "partition_join_paths": partition_joins,
                   "partition_special_paths": partition_specials,
                   "aggregation_paths": aggregations,
                   "named_window_path": named_windows,
                   "lineage_path": lineage,
                   "shard_path": sharded,
                   "redesign": redesign,
                   # K38 and K49's fold three ways beside their yardsticks
                   "redesign_pr20": {k: res[k] for k in ("partition_ring_view", "shard_fold")},
                   "ring_view_seq_W1024_ms": res["ring_view_seq"]["W1024_ms"],
                   "order_limit_store_query_shape": {
                       "ms": res["order_limit"]["query_ms"],
                       "plain_ms": res["order_limit"]["query_plain_ms"]},
                   "sort_kernel_shapes": {k: res[k] for k in SORT_KERNELS},
                   "aggregation_kernel_shapes": {
                       "agg_step_us_per_row": res["agg_step"]["us_per_row"],
                       "agg_step_closes": res["agg_step"]["closes"],
                       "agg_find_merge_per_ms": res["agg_find_merge"]["per_ms"],
                       "partition_cron_timer_step": {
                           k: res["partition_cron_window_step"][k]
                           for k in ("timer_ms", "timer_plain_ms", "timer_rows",
                                     "timer_bound_ms")}},
                   "partition_pattern_kernel_times": {
                       k: {x: res[k][x] for x in res[k] if x.endswith(("ms", "_bound_ms"))}
                       for k in PP_KERNELS},
                   "partition_pattern_kernel_shapes": {
                       "partition_pattern_advance_slot1_ms":
                           res["partition_pattern_advance"]["advance_ms"],
                       "partition_pattern_scan_timer_ms":
                           res["partition_pattern_scan"]["timer_ms"]},
                   "partition_window_kernel_shapes": {
                       "partition_batch_window_step_lengthbatch64_ms":
                           res["partition_batch_window_step"]["lengthbatch64_ms"]},
                   "table_kernel_shapes": {
                       "table_write_scan_ms": res["table_write"]["scan_ms"],
                       "table_match_in_ms": res["table_match"]["in_ms"],
                       "table_update_scan_ms": res["table_scan"]["update_ms"]}},
                  f, indent=1)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
