#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) end to end on one card.

    python3 chip_smoke.py [--rows 1000000] [--seed 0] [--profile]

Phases, each printing one JSON line:
  1. device   — card name and count, `nvidia-smi` name and power limit.
  2. build    — nvcc build of the kernels from `src/repro_torch/kernels/csrc`
                for sm_90a, its time and the ptxas register/smem/spill report.
  3. main     — the main path through the user entry points: Higgs-shaped
                data (28 features, generated from --seed) -> DeviceDMatrix on
                cuda -> Booster(10 rounds, depth 6, 256 bins, binary:logistic).fit
                with the reference's default growth (subtraction trick) ->
                predict on 100k held-out rows. Held-out accuracy must beat
                0.7, the raw-row predictions must agree with the bin-space
                traversal of a ref= matrix, and each kernel of the path must
                launch as often as the path says (counts reset just before,
                read just after): privatised histogram 10, row-id histogram
                50, split scan 60, cut selection 1, traversal 1. Where
                predict_s goes: a warm predict, the held-out rows' copy to
                the card alone, and a predict of rows already on the card.
  4. fit      — two further fits on the same matrix, each with its own
                counts: `use_kernel_histograms=True` (privatised histogram
                60, row-id 0) and `growth="lossguide", max_leaves=32`. Each
                must beat 0.7; the share of trees whose structure matches
                between the main and the kernel-path fit is a reading, not a
                gate (full builds against the default's float32 parent -
                child: other arithmetic). Then FIT_PAIRS warm, untraced pairs of the default and
                the kernel-path fit, alternating which runs first: the two
                growths end to end, like for like.
  5. dense    — the uncompressed-matrix fits on the same matrix
                (`compress_matrix=False`: one `CompressedMatrix.unpack()`, i.e.
                one decompress launch, before the first round), default and
                kernel path, each with its own counts: decompress 1, and
                privatised histogram 0 / row-id 0 / split scan 60 (the default
                growth's histograms are plain-torch scatters on dense bins) and
                60 / 0 / 60. Each must beat 0.7 and is bit for bit the packed
                fit of the same growth (trees and predict: the dense scatter
                adds the kernels' integers at their exponent); its accuracy
                gap and structure share to it are read. Then DENSE_PAIRS warm alternating
                pairs of the dense and the packed default fit.
  6. evals    — a fit of at most EVAL_ROUNDS rounds with the held-out rows as
                an eval set (`DeviceDMatrix(..., ref=dtrain)`), logloss and auc,
                early stopping after EARLY_STOP rounds: best_iteration, rounds
                run and kept, fit_s beside a fit of as many rounds without
                evals, its launches (the default growth's per round, no
                traversal, no decompress: eval margins update in bin space).
                Gates: the history's valid_auc at best_iteration equals
                `eval` of the model of best_iteration + 1 rounds (the final
                model when early stopping cut it there) within 1e-5, and
                `predict(iteration_range=ITERATION_RANGE)` of the main model is
                bit for bit the plain traversal of the sliced arenas, and
                fit(6) + update(4) is the main fit(10) bit for bit (trees,
                predict, margins). Readings: its structure share and largest
                margin gap, and the synchronising calls the evals add
                (`torch.cuda.set_sync_debug_mode("warn")`; the design reads
                metrics once a chunk). Then early stopping that fires: ES_KNOBS
                on the first ES_ROWS rows, the held-out rows as eval set,
                logloss, patience ES_PATIENCE; gates: it stops before its last
                round, keeps best_iteration + 1 rounds (trees and packed nodes),
                drops its margins, and predicts bit for bit as the plain
                traversal of the truncated model.
  7. objectives — 10-round fits of reg:quantile (alpha QUANTILE_ALPHA),
                reg:pseudohubererror and count:poisson on a regression target
                made from the seed (counts for Poisson), each with the default
                growth's launches; gate: each beats its constant baseline (its
                base score) on its own metric for the held-out rows. Then a
                registered copy of binary:logistic's gradient through
                `fit(obj=)`: its gradient bit for bit the built-in's on the
                main fit's margins, the main fit's launches, accuracy within
                0.003, the model bit for bit the main fit's. Readings: fit_s
                of each, and the share of its trees with the main fit's
                structure.
  8. persist  — the main model saved and loaded onto the card: predictions
                bit for bit, save -> load -> save the same bytes; the
                checkpoint the JAX package wrote (REFERENCE_CKPT) predicts its
                stored rows within REFERENCE_ATOL; a copy with one payload byte
                flipped raises CheckpointError; the model through XGBoost JSON
                (export, import onto the card) predicts bit for bit. Readings:
                file bytes, save and load seconds.
  9. serve    — a SERVED_ROUNDS-round fit saved and loaded, behind a
                `PredictEngine` with DEFAULT_BUCKETS, warmed up; SERVE_SIZES
                from the held-out rows, three times. Gates: every output bit
                for bit `Booster.predict`; one graph capture a bucket at warmup
                (trace_count and the traversal's launches both equal the
                buckets) and none, and no launch, during the stream;
                `output_margin=True` and `iteration_range=SERVE_RANGE` engines
                bit for bit the same `Booster.predict`; ±inf raises. Readings:
                p50/p99 ms and rows/s per size (SERVE_REPEATS calls) beside a
                warm `Booster.predict`, the 100k rows' copy to the card from
                pageable and from pinned memory, the engine's validation pass
                and staging copies of a 100k request; again for the 10-round
                main model (the kernel's share).
  10. rank    — an MSLR-WEB10K-shaped ranking fit at full width (RANK_ROWS
                rows in RANK_QUERIES queries, RANK_FEATURES features, made from
                --seed; query sizes, relevance shares and Σ g² printed), with a
                held-out set of RANK_HELD_QUERIES queries built with ref= as its
                eval set: rank:pairwise, 10 rounds, depth 6, 256 bins, default
                growth, ndcg@10. Gates: launches private 10 / row-id 50 / split
                scan 60 / pairwise 10; held-out ndcg@10 above the all-zero
                model's; the history's last ndcg@10 equals `eval` of the model
                within 1e-5, and ndcg@10 on the card equals the CPU's within
                1e-6; the grouping adds no synchronising call to a fit, nor the
                grouped metric any beyond a plain metric's (`count_syncs`,
                against the main fit with and without an eval set); save ->
                load -> predict bit for bit. Readings: build and fit seconds
                beside the main fit's.
  11. sklearn — the estimators on the card (HAVE_SKLEARN printed; without
                sklearn the local base classes run): XGBClassifier(10 rounds)
                on the main rows, predict_proba bit for bit its booster's
                predict and, with serve=True, its own serve=False answer,
                accuracy within 0.003 of the main fit's, launches 10/50/60;
                XGBRanker on the rank data by qid=, predict bit for bit its
                booster's, and group= sizes of the rows sorted by query giving
                their qid= array; XGBRegressor on the objectives phase's
                regression target, held-out RMSE below the constant's.
  12. stochastic — STOCH_FITS on the main matrix, each with its own counts
                and the launches of the table there; gates: each beats 0.7
                held out; the subsample and GOSS fits make no more
                synchronising calls than the default fit; the monotone fit
                learns MONOTONE_LABEL (its accuracy beside the unconstrained
                fit's on that label), and its margins
                (`predict(output_margin=True)`) along
                SWEEP_STEPS ascending values of feature 0 never fall and of
                feature 1 never rise, exactly, at SWEEP_ROWS held-out rows'
                other values; the card's draws are a function of their path
                (row selection, GOSS selection, a level's node masks the
                same twice, other with another seed) and its selections from
                uniforms drawn on the CPU equal the CPU's bit for bit; save ->
                load -> predict of the tuned and the monotone model bit for
                bit, the constraints back as a tuple. Readings: fit_s and
                accuracy beside the default fit's, STOCH_PAIRS warm pairs of
                subsample=0.5 against the default; fit(6) + update(4) against
                fit(10) with subsample=0.5, a gate: bit for bit.
  13. external — the main matrix as an `ExternalDMatrix` (ref= the flat
                matrix) at EXT_CHUNK_ROWS rows a chunk (8 chunks at 1M;
                EXT_CHUNK_ROWS_LARGE from 2M rows on) and at EXT_ODD_CHUNK_ROWS
                (not a multiple of a word's symbols, a short last chunk),
                each with its own counts. Gates: each chunk's words are the
                flat words of its rows bit for bit; the chunked default fit
                launches the flat fit's kernels as often (10/50/60: one
                launch a level over the whole stack); accuracy within 0.003
                of the main fit's; the model bit for bit the main fit's; `predict` on the chunks bit for bit
                `predict` on the flat matrix; an ExternalDMatrix eval set's
                last logloss and auc equal `eval` of the model on the flat
                eval set within 1e-5. Readings: stack bytes, build seconds,
                the first chunked fit's seconds (cold) beside the flat fit's
                warm median, EXT_PAIRS warm alternating pairs of the chunked
                and the flat fit (medians and their ratio), the fit's peak
                memory above what was allocated before it (the phase holds
                the dense bins of its check meanwhile), the share of trees
                with the main fit's structure. Then a
                sampled chunked fit (subsample 0.5, launches 0/60/60,
                accuracy > 0.7); `cuts="sketch"` from raw batches of
                EXT_BATCH_ROWS (accuracy > 0.7; read: the share of cuts equal
                to `compute_cuts`'); page-in faults on a fresh matrix of
                FAULT_ROWS rows in FAULT_CHUNKS chunks: `chunk_corrupt` once
                (one retry with a warning, then the host's words),
                always (ChunkIntegrityError naming the chunk), `chunk_load`
                twice (two retries, then the host's words).
  14. stream  — the main matrix as a streamed `ExternalDMatrix`
                (`paging="stream"`, ref= the flat matrix) at EXT_CHUNK_ROWS
                (EXT_CHUNK_ROWS_LARGE from 2M rows on) and EXT_ODD_CHUNK_ROWS
                rows a chunk, each at prefetch_chunks 2 and 0, beside a
                resident chunked fit of the same chunks (its stack unloaded
                before, so the fit's page-in counts). Gates: #1 launches
                10 x n_chunks (once a chunk a round), the row-id kernel as
                often as the streamed bins paged row segments (at most
                50 x n_chunks), the split scan 60; accuracy within 0.003 of
                the resident fit's and > 0.7; `nbytes_device` 0 after the
                fit and after predict; device slots = prefetch_chunks + 1 (at
                most n_chunks); the model bit for bit the resident fit's;
                the fit's peak device memory above what was allocated
                before it below the resident fit's by at least (stack
                bytes - (prefetch + 1) x chunk bytes) / 2; `predict` on the
                streamed matrix bit for bit the flat one; on FAULT_ROWS rows
                in FAULT_CHUNKS chunks, `chunk_load` once (one retry
                warning, the fit completes) and `chunk_corrupt` always
                (ChunkIntegrityError naming chunk 0). Readings: STREAM_PAIRS
                warm alternating pairs of the streamed and the resident fit
                and of prefetch 2 and 0 (medians, ratios); the pinned copy
                of one chunk by events (back to back) and the transfer floor
                it sets (chunks_paged x chunk bytes / rate); chunks_paged
                and rows_touched; the syncs of a streamed and a resident
                fit (`count_syncs`); a streamed GOSS fit's counters; the
                card's name and power limit.
  15. resilience — `nan_grad` armed at round NAN_ROUND of the 10-round
                default fit: "raise" raises NumericError naming the round,
                "warn_skip" skips it (its leaves zero, the margins finite),
                "clamp" records `gradients_clamped` (margins finite); a
                "raise" fit without a fault makes no more synchronising calls
                than the default fit's plus one (one chunk). Kill and resume:
                one child process a variant of RESUME_VARIANTS (default,
                subsample 0.5, early stopping), all at once, fits 10 rounds
                on the parent's rows with checkpoint_every=RESUME_EVERY and
                SIGKILLs itself once round RESUME_KILL is read; the parent
                resumes each snapshot. Gates: 10 rounds; the snapshot's
                trees bit for bit; its margins entered as carried (replayed
                through the resumed trees, they give the final margins bit
                for bit); accuracy within 0.003 of an uninterrupted fit, and
                bit for bit its trees, predict and final margins.
                `checkpoint_write` once (the retry succeeds) and always (a
                warning and a `checkpoint_write_failed` event a snapshot, the
                fit completes, the file written before is unchanged); `oom`
                with on_oom="external" (one `oom_fallback` at n_rows // 2, the
                fit through the chunk stack, launches 10/50/60, accuracy >
                0.7) and without (SimulatedOOM).
  16. dist    — multi-device training on this one card: the main matrix (its
                rows cut to a multiple of 4) sharded over DIST_SHARDS positions
                (`dist.make_mesh(..., device="cuda")`), one thread a shard.
                Gates: the psum fit at 2 and 4 shards launches #1 60 x S
                (every level in full on each shard), row-id 0, the split scan
                60 x S (every shard evaluates), decompress 1 (the words
                repacked a shard, cached); accuracy > 0.7 and within 0.003 of
                the kernel-path fit; every shard's trees equal bit for bit in
                every round; `predict` bit for bit the plain traversal. The
                collective alone on the 4 shards' root histograms: q16 psum,
                ring, hier and the (2, 2) hier equal and the CPU's bit for bit,
                the f32 ring the CPU's bit for bit, the f16 ring within
                2 S 2^-11 m_sum of the exact sum, tolerance 0 the f32 ring's
                result with every shard's tally 1. Strategy fits at 4 shards
                (ring, hier, hier on a (2, 2) mesh, f16 and q16 rings):
                launches, accuracy within 0.003 of the psum fit, comm_stats
                the CPU's dict, no fallback. At 2 shards: subsample 0.5 and
                GOSS (each shard's masked gh of round 0 gathered = the one-card
                masked gh bit for bit; accuracy > 0.7), a resident
                ExternalDMatrix of 8 chunks (the chunked #1 60 x S) and
                `compress_matrix=False` (decompress 1, #1 0), each within
                0.003 of the 2-shard psum fit (sharded against unsharded
                stays a tolerance: each shard's histogram is deterministic,
                but the collective adds the shards' float32 histograms, other
                arithmetic than one card's integers). `sharded_sketch_cuts(mesh=)` at
                2 and 4 shards: every cut of a feature whose cuts are all
                finite within 2 (S + 3) / 1024 of its target rank. A shard
                that raises ends the fit with its exception within
                DIST_FAIL_S, no thread left. Readings: fit_s, comm_stats bytes,
                ms a level-5 allreduce of each strategy and compression, the
                sketch's seconds, DIST_PAIRS warm rotations of 1-, 2- and
                4-shard fits.
  16b. repeat — every path fitted twice on the main matrix (default,
                kernel path, lossguide, dense, dense kernel path, subsample
                0.5, GOSS, colsample_bynode 0.5, monotone, the rank fit on
                its MSLR-shaped matrix, chunked and streamed at
                EXT_CHUNK_ROWS, psum on 2 shards of cuda:0): every ensemble
                field, `predict` on the held-out rows and the training
                margins bit for bit (the histograms' 64-bit fixed point:
                the same bits whatever the atomics' order).
  17. feature — feature-sharded growth (`grow_tree(feature_axis="model")`)
                on the main matrix's dense bins (`dtrain.matrix.unpack()`: one
                decompress), over FEATURE_MESHES of cuda:0 positions ((2, 2)
                and (1, 4) on ("data", "model"); `dist.shard_features`, the
                rows reduced by a psum over "data"), each with the default
                builder (`index_add_`) and the kernel builder
                (`ops.build_histograms_kernel`: pack + #1): a ROUNDS-round
                loop driven by the phase (gradients from the margins, one tree
                under `dist.spmd`, the margins moved by the bin-space
                traversal of the packed matrix), beside the same loop
                unsharded (feature_axis=None, one position). Gates: every
                position's tree bit for bit the same in every round; launches
                a tree split scan DEPTH x S, #1 0 (default) or DEPTH x S
                (kernel builder), row-id 0; held-out accuracy > 0.7 and
                within 0.003 of the unsharded loop's; raw-row margins of the
                model (thresholds psum'd from their owners) within 1e-5 of
                its bin-space margins; packed bins, a sample buffer and
                monotone constraints under feature_axis raise (the last
                before any launch). Readings: seconds a round at 1 / (1, 4) /
                (2, 2); the GBDT dry run (`launch/dryrun_gbdt.py`) of both
                modes on a DRYRUN_MESH of cuda:0 positions: bytes a position
                posted by kind, round seconds; the card's name and power
                limit.
  18. lm      — the LM substrate (`repro_torch.models`, `optimizer`,
                `launch/train.py`) at full width, cut in depth only, weights
                from the seed on the card: `train_loop` on yi-6b at 2 layers
                (d_model 4096, 32 heads, 4 KV heads, d_ff 11,008, vocab
                64,000, remat "dots_saveable"), batch 1 x seq 4,096 (the
                flash path), 10 steps (every loss finite, every leaf moved),
                then 8 AdamW steps on one batch (LM_OPT_LR, no decay: the
                last loss below the first); decode = forward over 12 steps at batch
                2 on that model with a bf16 cache (<= 2e-2 relative), and
                glm4-9b at 2 layers with the int8 cache (<= 0.05, its bytes
                under 0.7x the bf16 cache's); every other entry of ARCHS
                (LM_DEPTH) at full width: forward_logits (shape, finite), one
                loss_fn backward (finite, nonzero grad norm), 4 decode steps
                against the forward of the same 4 tokens (<= 2e-2);
                llama4-maverick at `reduced()` (one layer's 128 experts are
                16.1B parameters, 64.4 GB float32); reduced yi-6b and mamba2
                with weights carried from the CPU: the card's logits against
                the CPU's (LM_CARD_RTOL). Readings: seconds a step (median of
                steps 3-10), tokens/s, peak memory of each architecture, the
                cuBLAS bf16 reduced-precision flag.
  19. lm_dryrun — the LM's sharded dry run (`repro_torch.launch.dryrun`,
                the port's partition model): `run_one` for one architecture
                a family (LM_DRYRUN_ARCHS) at every shape on both production
                meshes, traced in LM_DRYRUN_JOBS processes (host work on meta
                tensors). Gates: no record is an error, the skips are the
                reference's (LM_DRYRUN_SKIPS); the largest argument_bytes
                that fits the card is allocated for real (a position's local
                parameters, AdamW state and batch) and
                `torch.cuda.memory_allocated()` grows by the record's bytes
                within the caching allocator's 512-byte rounding a tensor.
                One line a record (per-device argument and peak bytes, the
                roofline terms, the ops that fell back). Reading: the
                partition model's peak for the `lm` phase's training step
                (yi-6b, 2 layers, batch 1 x 4,096, one position) beside the
                peak the card measured there.
  20. ops     — the path the reference gives `histogram_packed` and
                `decompress`: `ops.histogram_packed_op`, `ops.decompress_op`
                and the matrix's own `CompressedMatrix.unpack()` on the
                training matrix's words, counts reset just before
                (`histogram_packed` 1, `decompress` 2).
  21. check   — each kernel against its plain PyTorch version on the same
                CUDA inputs, at the main path's shapes; the histograms also on
                a skewed copy of the words (SKEW of the symbols in the missing
                bin) and a constant-feature copy (one feature's every symbol
                in one value bin); the split scan bit for bit at 1, 8 and 32
                nodes and on a histogram whose best thresholds tie over empty
                runs of bins, each also with monotone constraints of every
                sign at bounds that clip and at ±inf, with an (F,) and an
                (n, F) feature mask (node 0 wholly masked), and with both;
                traversal also at depth 14, depth 13 with 4
                classes and 300 classes (exact); and the subtraction trick's
                device path at level 5 against a full build; the cut selection
                also on tied, constant, all-missing and one-value columns,
                bit for bit; the traversal at the serving shapes (SERVING:
                500 trees at depth 6 and 8, 700 trees x 7 classes, and 500
                trees at depth 6 whose every walk goes the full depth, over
                the 1M training rows), bit for bit; decompress bit for bit on
                the training matrix, on 4-bit symbols packed from known bins
                and on random words at every shape of DECOMPRESS_SHAPES (the
                plain version on word-aligned slices of the rows; past 2^31
                output elements, on the rows past element 2^31); the pairwise
                gradient on the rank fit's training scores after
                RANK_CHECK_ROUNDS rounds, at PAIR_GROUPS' query sizes (1, 2,
                120 and 1,251 rows, one query of 5,000, one of 50,000 rows), at
                a size just above each at which the kernel's work changes hands
                (33, 257 and 769 rows), on one relevance everywhere and on
                tied scores, within PAIR_RTOL * (1 + each row's summed term
                magnitudes) and bit for bit across two calls; the two histogram
                kernels' chunked instantiation on the external phase's chunk
                stacks and on the skewed words stacked at EXT_ODD_CHUNK_ROWS,
                against their chunked plain versions, held as the flat
                shapes are; every histogram instantiation also
                `torch.equal` to its fixed-point plain version and to a
                second call, and two chunk updates into one int64 slab at
                the pass's exponent `torch.equal` to one call, for both
                private kernels.
  22. time    — CUDA-event ms of each kernel, its plain version and, where one
                PyTorch call computes the same function, that call; beside
                the bound (bytes over 3.35 TB/s or operations over peak), with
                each private histogram's launch plan (node tile, feature
                group, shared bytes, blocks per SM from the plan and from
                `cudaOccupancyMaxActiveBlocksPerMultiprocessor`), and the
                privatised kernel also under the plans of 1, 2 and 3 blocks
                per SM (1: a block fills its opt-in shared memory, as the
                earlier fill plan did), on both word sets, the wrapper's own
                plan marked; the split scan at 1, 8 and 32 nodes beside an empty
                launch on the same stream, each also as device time per launch
                of 100 launches queued back to back, and its constrained and
                masked (half the (node, feature) problems) variants beside it;
                the main path's traversal with its arenas staged and read through L2, and with its rows
                from the other source (row tile or global memory) than its
                plan's; the traversal at each serving shape,
                its bound counting the levels the run's rows visit; the cut
                selection by events and back to back, beside
                `compute_cuts_op` and the candidate sort it no longer runs;
                decompress by events and back to back at the main shape and
                at each timed shape of DECOMPRESS_SHAPES, beside its bound
                and `copy_` of as many bytes read and written (what the card
                reaches on the same traffic; no port code calls it); the
                pairwise kernel at the rank fit's shape and at each of
                PAIR_GROUPS' shapes by events and back to back, beside its
                bound from those pairs and the bound of their exps and
                reciprocals at the special-function units' rate, at the rank
                shape its plain version and `ops.query_groups`; each histogram kernel's
                chunked instantiation beside its flat one on the same rows (#1
                at 1 and 8 nodes, the row-id kernel at 1 and 16 parents, each
                chunk stack of the external phase), by events and back to
                back, each beside its bound in bytes, and its chunked plain
                version.
With --profile, seven further fits are traced after the dist phase,
each printing its device busy time, idle share, launches and top kernels:
the default, the dense default, EVAL_ROUNDS rounds with and without the
evals, subsample=0.5, the default on the streamed matrix and the 2-shard
default fit (tables
profile_{fit,dense,evals,no_evals,subsample,stream,dist}.txt in the output
directory, by device time and then by host time).
Then the kernels line (each kernel's launches on the path that runs it:
the main path's, histogram_packed's in the ops phase, decompress's in the
dense default fit, pairwise_grad's in the rank fit), the `nvidia-smi` line and, last,
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; there is
no CPU path. Runs from the root of a checkout of the repository.
"""
from __future__ import annotations

import argparse
import copy
import functools
import json
import re
from signal import SIGKILL
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
HELD_OUT = 100_000
ROUNDS, DEPTH, MAX_BINS = 10, 6, 256
HIST_NODES = (1, 8, 32)  # full-level histograms checked: levels 0, 3 and 5
ROW_PARENTS = (1, 4, 16)  # row-id histograms checked: parents of levels 1, 3, 5
ALTERNATING_ROUNDS = 5  # #1 at 32 nodes and scatter_add_, timed in turns
FIT_PAIRS = 5  # host times vary between fits: the median of five pairs
L2_FLUSH_BYTES = 128 << 20  # more than the 50 MB L2, written between timed launches
SKEW = 0.8  # share of the skewed words' symbols moved to the missing bin
CONSTANT_BIN = 7  # every symbol of the constant-feature words' feature 0
# Best split thresholds tied over an empty run of bins: the run starts at
# these bins (lane c % 32 of the scan's warp scores threshold c, so the ties
# span lanes and, from 31 on, wrap from lane 31 to lane 0).
TIE_STARTS = (8, 32, 33, 100)
TIE_GAP = 5
# Traversal shapes past the staged route's shared memory: (trees, depth,
# classes, rows) — packed arenas of 256 KB and 128 KB (two stages do not fit
# a block), sums of 300 classes (tiled over the grid).
DEEP_TRAVERSALS = ((4, 14, 1, HELD_OUT), (8, 13, 4, HELD_OUT), (600, 6, 300, 20_000))
# A served model's size over the training rows: (trees, depth, classes,
# share of the internal levels' nodes that are leaves). The README trains
# n_rounds=500; 700 trees are 100 rounds of a 7-class (covtype-shaped)
# model. A fifth of the nodes leaves stops a depth-6 walk after ~2.9 levels;
# a model fitted on 1M rows splits every node it reaches above its last
# level, which share 0.0 gives: every walk takes the full depth.
SERVING = ((500, 6, 1, 0.2), (500, 8, 1, 0.2), (700, 6, 7, 0.2), (500, 6, 1, 0.0))
# decompress beyond the training matrix, on random words made on the card
# (any words are valid input: each field is masked): (name, rows, features,
# bits, timed). The main shape at its other widths, the Bosch-shaped matrix
# (`DATASETS["bosch"]`), the paper's 11M-row Higgs run, and one past 2^31
# output elements (77M x 28, 8.6 GB out), checked on the rows past element
# 2^31 and not timed.
DECOMPRESS_SHAPES = (("bits_4", 1_000_000, 28, 4, True), ("bits_9", 1_000_000, 28, 9, True),
                     ("bits_32", 1_000_000, 28, 32, True),
                     ("bosch", 1_183_747, 968, 8, True),
                     ("higgs_11m", 11_000_000, 28, 8, True),
                     ("past_2_31", 77_000_000, 28, 8, False))
DECOMPRESS_CHECK_ELEMENTS = 1 << 26  # elements a slice of decompress's plain check

# Where each kernel's TPU original lives (file:line of its pallas_call). The
# row-id histogram extends the privatised kernel to the function the
# reference computes in XLA for the subtraction trick.
REPLACES = {
    "histogram_private": "src/repro/kernels/histogram.py:332",
    "histogram_rows": "src/repro/core/histogram.py:369",
    "histogram_packed": "src/repro/kernels/histogram.py:131",
    "split_scan": "src/repro/kernels/split_scan.py:81",
    "quantile_cuts": "src/repro/kernels/quantile_cuts.py:100",
    "ensemble_traversal": "src/repro/kernels/ensemble_traversal.py:175",
    "decompress": "src/repro/kernels/decompress.py:45",
    "pairwise_grad": "src/repro/core/objectives.py:289",
    # Port-only: the fixed-point exponent of the histograms #1 and row-id
    # (the reference adds float32); it serves the first's TPU kernel.
    "fixed_exponent": "src/repro/kernels/histogram.py:332",
}
SOURCES = {name: "src/repro_torch/kernels/csrc/"
           + ("histogram" if name.startswith("histogram") or name == "fixed_exponent" else
              "pairwise" if name == "pairwise_grad" else name) + ".cu"
           for name in REPLACES}
# Inputs of the exponent kernel's edge check: (name, (g, h) rows).
EXPONENT_EDGES = (("no_rows", []), ("one_row", [[0.75, -3.0]]), ("all_zero", [[0.0, 0.0]] * 1000),
                  ("subnormal", [[1e-40, -1e-40]] * 17), ("two_to_127", [[2.0**127, 1.0]]),
                  ("inf", [[1.0, float("inf")]]), ("nan", [[float("nan"), 0.5]]))
# Further fits on the main matrix: Booster knobs beside the main path's.
FITS = {
    "kernel": {"use_kernel_histograms": True},
    "lossguide": {"growth": "lossguide", "max_leaves": 32},
}
DENSE_PAIRS = 3  # warm alternating pairs of the dense and the packed default fit
EVAL_ROUNDS, EARLY_STOP = 40, 5  # the evals fit: at most 40 rounds, chunks of 5
ITERATION_RANGE = (2, 7)  # rounds of the main model predicted alone
# A fit whose held-out logloss turns within a few rounds, so early stopping
# fires: a high learning rate and deep trees on a slice of the rows.
ES_ROWS, ES_PATIENCE = 50_000, 3
ES_KNOBS = {"n_rounds": 40, "learning_rate": 1.0, "max_depth": 8}
QUANTILE_ALPHA = 0.9  # reg:quantile's alpha in the objectives phase
# The checkpoint the JAX package wrote (tools/make_reference_checkpoint.py),
# its rows and predictions beside it; the CPU test of the same load states
# the tolerance: float32 rounding of the leaf sums and the sigmoid.
REFERENCE_CKPT = ROOT / "tests" / "data" / "repro_booster_v2.ckpt"
REFERENCE_ATOL = 1e-6
# Serving: a served model's size, the request sizes of the stream (each
# bucket edge and past it, and a request of many top-bucket slices), the
# calls a size for the latency readings, and a staged engine's rounds.
SERVED_ROUNDS = 500
SERVE_SIZES = (1, 3, 16, 17, 100, 1_000, 8_192, 8_193, HELD_OUT)
SERVE_REPEATS = 30
SERVE_RANGE = (0, 100)
# Ranking: MSLR-WEB10K Fold 1's training set (Microsoft Learning to Rank
# datasets) in shape: 723,412 rows in 6,000 queries, 136 features; query
# sizes log-normal around its median and mean (90, ~120), clipped to its
# largest query; relevance 0-4 at about its label shares. A held-out set of
# RANK_HELD_QUERIES more queries. Made from --seed.
RANK_ROWS, RANK_QUERIES, RANK_FEATURES = 723_412, 6_000, 136
RANK_MEDIAN, RANK_SIGMA, RANK_MAX_QUERY = 90, 0.75, 1_251
RANK_SHARES = (0.52, 0.32, 0.13, 0.02, 0.01)  # relevance 0, 1, 2, 3, 4
RANK_HELD_QUERIES = 1_000
RANK_CHECK_ROUNDS = 3  # the check's scores: after 3 rounds, not all at rho = 0.5
# The pairwise kernel's other checked shapes: query sizes of (name, size,
# rows) and of one query of all rows; tolerance 2e-6 * (1 + sum |term|).
PAIR_GROUPS = (("groups_1", 1, 50_000), ("groups_2", 2, 50_000), ("groups_120", 120, 50_040),
               ("groups_1251", 1_251, 50_040), ("one_5000", 5_000, 5_000),
               ("one_all_rows", 50_000, 50_000))
PAIR_RTOL = 2e-6
# The special-function units of an H100 SXM: 16 exp2 or reciprocal results a
# clock on each SM, at its 1,980 MHz boost clock.
SFU_OPS_PER_S = 16 * 132 * 1.98e9
# Stochastic and constrained fits on the main matrix: the knobs XGBoost users
# tune first, and each fit's launches (privatised, row-id, split scan,
# decompress). A sampled fit grows over its compacted row buffer (the row-id
# kernel at every level, the root included); column sampling and monotone
# constraints keep the default growth; the kernel path samples in masked
# mode; the dense fit gathers the buffer's rows once a tree. Feature 0 is
# constrained to rise and feature 1 to fall (the Higgs shape has 28). The
# monotone fit learns a label of the same rows that does rise with feature
# 0 and fall with feature 1 (MONOTONE_LABEL in the stochastic phase): the
# Higgs-shaped label couples both to other features through its pairwise
# terms, and a constraint against the data's shape costs the model its
# accuracy (0.6354 held out at 1M rows on the Higgs-shaped label, on the
# card and on the CPU alike).
MONOTONE = (1, -1) + (0,) * 26
STOCH_FITS = {
    "subsample": ({"subsample": 0.5}, (0, 60, 60, 0)),
    "tuned": ({"subsample": 0.8, "colsample_bytree": 0.8, "colsample_bylevel": 0.8,
               "colsample_bynode": 0.8}, (0, 60, 60, 0)),
    "colsample": ({"colsample_bynode": 0.5}, (10, 50, 60, 0)),
    "goss": ({"sampling_method": "goss", "top_rate": 0.2, "other_rate": 0.1}, (0, 60, 60, 0)),
    "monotone": ({"monotone_constraints": MONOTONE}, (10, 50, 60, 0)),
    "kernel_masked": ({"subsample": 0.5, "use_kernel_histograms": True}, (60, 0, 60, 0)),
    "dense": ({"subsample": 0.5, "compress_matrix": False}, (0, 0, 60, 1)),
}
STOCH_PAIRS = 3  # warm alternating pairs of the subsample=0.5 and the default fit
SWEEP_ROWS, SWEEP_STEPS = 1_000, 64  # the monotone sweep: held-out rows x ascending values
# External memory: the main matrix as a chunk stack of the reference's
# default 131,072 rows a chunk (8 chunks at 1M rows; 1,048,576 from 2M rows
# on, 11 chunks at 11M), and of 100,003 rows (not a multiple of the 4
# symbols of an 8-bit word: chunks whose words do not line up with the flat
# words, a short last chunk); the held-out rows as an ExternalDMatrix eval
# set of 30,000-row chunks; the sketch-cut matrix from batches of 125,000
# rows; the page-in faults on a fresh matrix of the first 200,000 rows in 4
# chunks.
EXT_CHUNK_ROWS, EXT_CHUNK_ROWS_LARGE, EXT_ODD_CHUNK_ROWS = 131_072, 1_048_576, 100_003
EXT_EVAL_CHUNK_ROWS, EXT_BATCH_ROWS = 30_000, 125_000
EXT_PAIRS = 3  # warm alternating pairs of the chunked and the flat default fit
DIST_SHARDS = (2, 4)  # shard counts of the dist phase, every position on cuda:0
DIST_PAIRS = 3  # warm rotations of the 1-, 2- and 4-shard default fits
DIST_FAIL_S = 30.0  # a fit whose shard raises must end within this many seconds
DIST_SKETCH_CAPACITY = 1024  # sharded_sketch_cuts' default summary size
# Feature-sharded growth: meshes of cuda:0 positions on ("data", "model"),
# and the GBDT dry run's mesh at its default rows and features: (4, 4), as
# a baseline round at the reference's (16, 16), 256 threads on the one
# card, takes over a minute (82 s; PERF.md §6).
FEATURE_MESHES = ((2, 2), (1, 4))
DRYRUN_MESH, DRYRUN_ROWS, DRYRUN_FEATURES = (4, 4), 1 << 20, 13
STREAM_PAIRS = 3  # warm alternating pairs: streamed vs resident, prefetch 2 vs 0
# The LM phase: full-width architectures cut in depth only (zamba2: one
# group of 6 mamba layers and one rest layer, so both loops run; seamless 2
# encoder + 2 decoder layers; llama4-scout one layer: 4.15B parameters,
# 16.6 GB float32). llama4-maverick runs at reduced(): one layer's 128
# experts alone are 16.1B parameters (64.4 GB float32), past the card with
# their gradients.
LM_DEPTH = {"zamba2-7b": {"n_layers": 7}, "seamless-m4t-medium": {"n_layers": 2, "n_enc_layers": 2},
            "llama4-scout-17b-a16e": {"n_layers": 1}}
LM_REDUCED = {"llama4-maverick-400b-a17b": "one layer's 128 experts are 16.1B parameters, "
              "64.4 GB in float32: with their gradients past the card's 80 GB"}
LM_TRAIN_STEPS, LM_TRAIN_SEQ, LM_OPT_STEPS = 10, 4_096, 8
# The one-batch AdamW steps' rate: the reference's test (5e-3 at width 256,
# test_arch_smoke.py:55-77) diverged at d_model 4096 (8 losses 11.61, 14.16,
# 8.96, 11.28, 18.77, 18.52, 20.06, 20.08 on an NVIDIA H100 80GB HBM3 at
# 700 W; AdamW moves every weight by about the rate a step, a third of
# yi-6b's initial weights' 0.016).
LM_OPT_LR = 1e-4
LM_SEQ, LM_DECODE_STEPS = 256, 4  # every other architecture's forward / backward, decode
LM_DECODE_RTOL, LM_INT8_RTOL = 2e-2, 0.05  # the reference's own (test_arch_smoke.py:103, :153)
LM_CARD_RTOL = 2e-2  # card vs CPU logits, as tests/test_torch_cuda.py states it
# The LM dry run: one architecture a family (dense GQA, MoE, SSM, hybrid,
# enc-dec), every shape, both production meshes; the reference's skips.
LM_DRYRUN_ARCHS = ["yi-6b", "llama4-scout-17b-a16e", "mamba2-2.7b", "zamba2-7b",
                   "seamless-m4t-medium"]
LM_DRYRUN_SKIPS = {("seamless-m4t-medium", "long_500k"): "enc-dec translation decoder: "
                   "target length architecturally bounded far below 500k (DESIGN.md §6)"}
LM_DRYRUN_JOBS = 8
FAULT_ROWS, FAULT_CHUNKS = 200_000, 4
# Resilience: the round whose gradients the nan_grad fault overwrites; kill
# and resume of a 10-round fit that snapshots every 3 rounds and is killed
# once round 5 is read (the snapshot of round 3 survives), for the default
# fit, subsample 0.5 and early stopping (patience 3, logloss on the held-out
# rows); the child fits the rows the parent saved, so its matrix is the
# parent's, bit for bit.
NAN_ROUND = 3
RESUME_EVERY, RESUME_KILL = 3, 5
RESUME_VARIANTS = {"plain": ({}, None), "subsample": ({"subsample": 0.5}, None),
                   "early_stopping": ({}, 3)}
RESUME_CHILD = """
import os, signal, sys
sys.path.insert(0, {src!r})
import numpy as np
from repro_torch.core import Booster, DeviceDMatrix
r = np.load({rows!r})
d = DeviceDMatrix(r["x_tr"], label=r["y_tr"])
evals = [(DeviceDMatrix(r["x_te"], label=r["y_te"], ref=d), "valid")] if {es!r} else []
def kill(rnd, rec):
    if rnd >= {kill}:
        os.kill(os.getpid(), signal.SIGKILL)
Booster(**{kw!r}).fit(d, evals=evals, early_stopping_rounds={es!r},
                      eval_metric="logloss" if {es!r} else None,
                      checkpoint_every={every}, checkpoint_path={path!r}, callback=kill)
print("FIT-COMPLETED")
"""


def lm_phase(dev, seed: int) -> float:
    """Phase 18: the LM substrate at full width, cut in depth only (see the
    module docstring). Emits one line a part; any failed gate raises.
    Returns the training loop's peak memory (GiB)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.launch import train as LT
    from repro_torch.models import NO_SHARDING, build_model, params_from_numpy, params_to_numpy
    from repro_torch.optimizer import AdamWConfig, adamw_init, adamw_update, global_norm
    from repro_torch.pytree import leaves, unflatten_like

    bad = []
    rel = lambda a, b: float((a.float() - b.float()).abs().max() / b.float().abs().max())
    gib = lambda n: n / 2**30

    def fresh():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    def n_params(params) -> int:
        return sum(p.numel() for p in leaves(params))

    def tokens(cfg, b, s, salt):
        g = torch.Generator(device=dev).manual_seed(seed * 1000 + salt)
        return torch.randint(0, cfg.vocab_size, (b, s), device=dev, generator=g)

    def lm_batch(cfg, b, s, salt):
        t = tokens(cfg, b, s, salt)
        batch = {"tokens": t, "targets": torch.roll(t, -1, dims=1)}
        g = torch.Generator(device=dev).manual_seed(seed * 1000 + salt + 1)
        if cfg.arch_type == "vlm":
            batch["prefix_embeds"] = 0.02 * torch.randn(
                (b, cfg.n_prefix_tokens, cfg.d_model), device=dev, generator=g)
        if cfg.arch_type in ("audio", "encdec"):
            batch["src_embeds"] = 0.02 * torch.randn((b, 64, cfg.d_model), device=dev,
                                                     generator=g)
        return batch

    def decode_vs_forward(model, params, batch, steps, cache_dtype=torch.bfloat16):
        """`steps` decode steps from an empty cache against forward_logits of
        the same tokens; (relative gap, cache bytes)."""
        with torch.no_grad():
            fwd_batch = {k: v for k, v in batch.items() if k not in ("targets", "prefix_embeds")}
            fwd_batch["tokens"] = batch["tokens"][:, :steps]
            full = model.forward_logits(params, fwd_batch, NO_SHARDING)
            b = batch["tokens"].shape[0]
            cache = model.init_cache(b, steps, dtype=cache_dtype, device=dev)
            nbytes = sum(x.numel() * x.element_size() for x in leaves(cache))
            if "src_embeds" in batch:
                from repro_torch.models import encdec as ED

                enc_out = ED.encode(params, batch["src_embeds"], model.cfg, NO_SHARDING)
            outs = []
            for t in range(steps):
                db = {"tokens": batch["tokens"][:, t:t + 1]}
                if "src_embeds" in batch:
                    db["enc_out"] = enc_out
                logits, cache = model.decode_fn(params, db, cache, t, NO_SHARDING)
                outs.append(logits[:, 0])
            return rel(torch.stack(outs, 1), full), nbytes

    line = {"phase": "lm", "bf16_reduced_precision_reduction":
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32}

    # --- training at full width: yi-6b, 2 layers, seq 4,096 -----------------
    cfg = dataclasses.replace(get_arch("yi-6b"), n_layers=2)
    base = fresh()
    t0 = time.perf_counter()
    params, hist = LT.train_loop(cfg, LM_TRAIN_STEPS, 1, LM_TRAIN_SEQ, seed=seed, log_every=1,
                                 device=dev)
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    losses = [h["loss"] for h in hist]
    elapsed = [h["elapsed_s"] for h in hist]
    step_s = float(np.median(np.diff(elapsed)[1:]))  # steps 3-10
    init = build_model(cfg).init_params(seed, dev)
    moved = [bool((a != b).any()) for a, b in zip(leaves(params), leaves(init))]
    del init
    train = {"arch": "yi-6b", "n_layers": 2, "params": n_params(params), "batch": 1,
             "seq": LM_TRAIN_SEQ, "remat": cfg.remat_policy, "steps": LM_TRAIN_STEPS,
             "losses": losses, "train_loop_s": train_s, "step_s_median_3_10": step_s,
             "tokens_per_s": LM_TRAIN_SEQ / step_s, "peak_gib": gib(peak),
             "leaves_moved": sum(moved), "leaves": len(moved)}
    if not (all(np.isfinite(losses)) and all(moved)):
        bad.append({"train": "a loss not finite or a leaf unmoved"})
    # 8 AdamW steps on one batch at a constant rate (the reference's
    # test_one_opt_step_reduces_loss, at LM_OPT_LR): the last loss below the
    # first.
    model = build_model(cfg)
    batch = lm_batch(cfg, 1, LM_TRAIN_SEQ, 1)
    acfg = AdamWConfig(lr=LM_OPT_LR, weight_decay=0.0)
    state = adamw_init(params)
    one = []
    for _ in range(LM_OPT_STEPS):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss = model.loss_fn(unflatten_like(params, flat), batch, NO_SHARDING)
        grads = torch.autograd.grad(loss, flat)
        params, state = adamw_update(params, unflatten_like(params, list(grads)), state, acfg)
        one.append(loss.item())
    train["one_batch_lr"], train["one_batch_losses"] = LM_OPT_LR, one
    if not one[-1] < one[0]:
        bad.append({"one_batch": one})
    del state, grads, flat, loss
    line["train"] = train
    emit({**line})

    # --- decode = forward at full width --------------------------------------
    decode = {}
    fresh()
    gap, bf16_bytes = decode_vs_forward(model, params, lm_batch(cfg, 2, 12, 2), 12)
    decode["yi-6b"] = {"n_layers": 2, "batch": 2, "steps": 12, "rel": gap,
                       "cache_bytes": bf16_bytes}
    if not gap <= LM_DECODE_RTOL:
        bad.append({"decode": "yi-6b", "rel": gap})
    del params
    cfg8 = dataclasses.replace(get_arch("glm4-9b"), n_layers=2, kv_cache_dtype="int8")
    model8 = build_model(cfg8)
    fresh()
    params = model8.init_params(seed, dev)
    b8 = lm_batch(cfg8, 2, 12, 3)
    gap8, int8_bytes = decode_vs_forward(model8, params, b8, 12)
    _, glm_bf16_bytes = decode_vs_forward(
        build_model(dataclasses.replace(cfg8, kv_cache_dtype="bfloat16")), params, b8, 12)
    decode["glm4-9b:int8"] = {"n_layers": 2, "batch": 2, "steps": 12, "rel": gap8,
                              "cache_bytes": int8_bytes, "bf16_cache_bytes": glm_bf16_bytes,
                              "bytes_ratio": int8_bytes / glm_bf16_bytes}
    if not (gap8 <= LM_INT8_RTOL and int8_bytes < 0.7 * glm_bf16_bytes):
        bad.append({"decode": "glm4-9b:int8", "rel": gap8, "ratio": int8_bytes / glm_bf16_bytes})
    del params
    emit({"phase": "lm", "decode": decode})

    # --- every entry of ARCHS at full width, cut in depth only ---------------
    for arch in ARCHS:
        cfg = get_arch(arch)
        if arch in LM_REDUCED:
            cfg, cut = cfg.reduced(), {"reduced": LM_REDUCED[arch]}
        else:
            cut = LM_DEPTH.get(arch, {"n_layers": 2})
            cfg = dataclasses.replace(cfg, **cut)
        model = build_model(cfg)
        base = fresh()
        t0 = time.perf_counter()
        params = model.init_params(seed, dev)
        batch = lm_batch(cfg, 1, LM_SEQ, 10 + ARCHS.index(arch))
        with torch.no_grad():
            logits = model.forward_logits(params, batch, NO_SHARDING)
        extra = cfg.n_prefix_tokens if cfg.arch_type == "vlm" else 0
        shape_ok = tuple(logits.shape) == (1, LM_SEQ + extra, cfg.padded_vocab)
        finite = bool(torch.isfinite(logits).all())
        del logits
        flat = [p.requires_grad_(True) for p in leaves(params)]
        loss = model.loss_fn(params, batch, NO_SHARDING)
        grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
        gnorm = float(global_norm(list(grads)))
        loss = float(loss)
        del grads
        for p in flat:
            p.requires_grad_(False)
        gap, _ = decode_vs_forward(model, params, batch, LM_DECODE_STEPS)
        torch.cuda.synchronize()
        rec = {"phase": "lm", "arch": arch, **cut, "d_model": cfg.d_model,
               "params": n_params(params), "seq": LM_SEQ, "logits_shape_ok": shape_ok,
               "logits_finite": finite, "loss": loss, "grad_norm": gnorm,
               "decode_steps": LM_DECODE_STEPS, "decode_rel": gap,
               "peak_gib": gib(torch.cuda.max_memory_allocated() - base),
               "seconds": time.perf_counter() - t0}
        emit(rec)
        if not (shape_ok and finite and np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0
                and gap <= LM_DECODE_RTOL):
            bad.append({k: rec[k] for k in ("arch", "logits_shape_ok", "logits_finite", "loss",
                                            "grad_norm", "decode_rel")})
        del params, flat, batch

    # --- the card against the CPU's plain path, weights carried ---------------
    card = {}
    for arch in ("yi-6b", "mamba2-2.7b"):
        cfg = get_arch(arch).reduced()
        model = build_model(cfg)
        host = params_to_numpy(model.init_params(seed, "cpu"))
        toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
        with torch.no_grad():
            on_cpu = model.forward_logits(params_from_numpy(host, "cpu"),
                                          {"tokens": torch.from_numpy(toks)}, NO_SHARDING)
            on_card = model.forward_logits(params_from_numpy(host, dev),
                                           {"tokens": torch.from_numpy(toks).to(dev)},
                                           NO_SHARDING)
        card[arch] = rel(on_card.cpu(), on_cpu)
        if not card[arch] <= LM_CARD_RTOL:
            bad.append({"card_vs_cpu": arch, "rel": card[arch]})
    fresh()
    emit({"phase": "lm", "card_vs_cpu": card, "tolerance": LM_CARD_RTOL,
          "nvidia_smi": nvidia_smi()})
    if bad:
        raise SystemExit(f"lm phase failed: {bad}")
    return train["peak_gib"]


def lm_dryrun_phase(dev, train_peak_gib: float) -> None:
    """Phase 19: the LM's sharded dry run (see the module docstring).
    Emits one line a record and a summary line; a failed gate raises."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.dist import make_mesh
    from repro_torch.launch import dryrun as LD
    from repro_torch.launch import specs as LS
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build_model
    from repro_torch.models.config import SHAPES, ShapeConfig

    smi = nvidia_smi()
    dev_name = f"cuda:{dev.index or 0}"
    t0 = time.perf_counter()
    pairs = [(a, s) for a in LM_DRYRUN_ARCHS for s in SHAPES]
    order = {(a, s, m): i for i, (a, s) in enumerate(pairs)
             for m in ("pod16x16", "pod2x16x16")}
    recs = sorted(LD.sweep(pairs, [False, True], "", dev_name, LM_DRYRUN_JOBS, smi),
                  key=lambda r: order[(r["arch"], r["shape"], r["mesh"])])
    sweep_s = time.perf_counter() - t0
    for rec in recs:
        print(LD.line(rec), flush=True)
    errors = [(r["arch"], r["shape"], r["mesh"], r.get("error")) for r in recs
              if r["status"] == "error"]
    skips = {(r["arch"], r["shape"]): r["reason"] for r in recs if r["status"] == "skipped"}
    skips_ok = skips == LM_DRYRUN_SKIPS and len(recs) == 2 * len(pairs)

    # A position's arguments for real: the largest record that fits the card.
    free, _ = torch.cuda.mem_get_info(dev)
    ok = [r for r in recs if r["status"] == "ok"]
    fits = [r for r in ok if r["memory_analysis"]["argument_bytes"] < 0.9 * free]
    big = max(fits, key=lambda r: r["memory_analysis"]["argument_bytes"])
    shape = SHAPES[big["shape"]]
    cfg = LS.cfg_for_shape(get_arch(big["arch"]), shape)
    mesh = make_production_mesh(multi_pod=big["mesh"] == "pod2x16x16", device=dev)
    _, structs, specs = LD.build_step(build_model(cfg), cfg, shape, mesh)
    leaves_read = big["argument_leaves"]
    read = (None if leaves_read["read"] == leaves_read["total"]
            else LD.partition_of(cfg, shape, mesh)["arguments_read"])
    want = big["memory_analysis"]["argument_bytes"]
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    local = LD.local_arguments(structs, specs, mesh, dev, read)
    grew = torch.cuda.memory_allocated(dev) - base
    alloc_ok = 0 <= grew - want < 512 * len(local)
    n_local = len(local)
    del local
    torch.cuda.empty_cache()

    # Reading: the partition model's peak for the lm phase's training step.
    cfg2 = dataclasses.replace(get_arch("yi-6b"), n_layers=2)
    one = make_mesh((1, 1), ("data", "model"), device=dev)
    shape2 = ShapeConfig("train_4k", LM_TRAIN_SEQ, 1, "train")
    _, s2, sp2 = LD.build_step(build_model(cfg2), cfg2, shape2, one)
    p2 = LD.partition_of(cfg2, shape2, one)
    est = (LD.argument_bytes(s2, sp2, one, p2["arguments_read"]) + p2["temp_bytes_peak"]
           + p2["output_bytes"])
    line = {"phase": "lm_dryrun", "records": len(recs), "ok": len(ok),
            "skipped": sum(r["status"] == "skipped" for r in recs), "errors": errors,
            "skips_as_reference": skips_ok, "sweep_s": sweep_s, "jobs": LM_DRYRUN_JOBS,
            "trace_s": {f"{r['arch']}:{r['shape']}:{r['mesh']}": r["trace_s"] for r in ok},
            "fallback_ops": sorted({k for r in ok for k in r["partition"]["fallback_ops"]}),
            "allocated": {"arch": big["arch"], "shape": big["shape"], "mesh": big["mesh"],
                          "record_bytes": want, "memory_allocated_grew": grew,
                          "tensors": n_local, "within_rounding": alloc_ok},
            "train_peak_estimate_gib": est / 2**30, "train_peak_card_gib": train_peak_gib,
            "nvidia_smi": smi}
    emit(line)
    if errors or not skips_ok or not alloc_ok:
        raise SystemExit(f"lm_dryrun phase failed: errors {errors}, skips {skips}, "
                         f"allocation {line['allocated']}")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def template_args(mangled: str) -> list[str]:
    """A kernel's template arguments from its mangled name: integers
    (`Li2E`) and classes, nested ones too (`NS_14ShuffleTilesOfINS_7SigmoidEEE`
    is `ShuffleTilesOf<Sigmoid>`)."""
    def args(rest: str) -> tuple[list[str], str]:  # up to and past the closing E
        out = []
        while rest and rest[0] != "E":
            if t := re.match(r"L[ib](\d+)E", rest):
                out.append(t.group(1))
                rest = rest[t.end():]
            elif t := re.match(r"(N(?:S_|\d+_GLOBAL__N_1))?(\d+)", rest):
                stop = t.end() + int(t.group(2))
                name, rest = rest[t.end():stop], rest[stop:]
                if rest.startswith("I"):
                    inner, rest = args(rest[1:])
                    name += f"<{','.join(inner)}>"
                if t.group(1):
                    rest = rest[1:]  # the N...E around a namespaced name
                out.append(name)
            else:
                return out, ""
        return out, rest[1:]

    at = mangled.find("_kernelI")
    return args(mangled[at + len("_kernelI"):])[0] if at >= 0 else []


def ptxas_summary(report: str) -> list[dict]:
    """Registers, shared memory and spills per compiled kernel function."""
    rows, cur = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = re.search(r"\d([a-z][a-z_]*_kernel)", mangled)
            # Template arguments: the split scan's <kMask, kMono>; #1's <SPW,
            # MIN_BLOCKS, kChunked>, the row-id kernel's <SPW, kChunked>; the
            # pairwise kernels' <Tiles, kWarpMax> and <Tiles>.
            targs = template_args(mangled)
            cur = {"function": (name.group(1) if name else mangled)
                   + (f"<{','.join(targs)}>" if targs else "")}
            rows.append(cur)
        elif cur is not None and "Used" in line and "registers" in line:
            cur["ptxas"] = line.split("ptxas info    :")[-1].strip()
        elif cur is not None and "spill" in line:
            cur["spill"] = line.split(":")[-1].strip()
    return rows


def path_launches(use_kernel_histograms: bool = False, dense: bool = False) -> dict[str, int]:
    """Launches of the growth kernels in one fit of ROUNDS trees, DEPTH levels
    each: every level scans its splits; the default growth histograms the
    root in full and every level below by the row-id kernel, the kernel path
    every level in full. On dense bins (`compress_matrix=False`) the default
    growth's histograms are plain-torch scatters, no kernel."""
    full = ROUNDS * (DEPTH if use_kernel_histograms else 1)
    rows = ROUNDS * DEPTH - full
    if dense and not use_kernel_histograms:
        full = rows = 0
    return {"histogram_private": full, "histogram_rows": rows, "split_scan": ROUNDS * DEPTH}


def count_syncs(fn) -> int:
    """Synchronising calls that `fn` makes, as
    `torch.cuda.set_sync_debug_mode("warn")` reports them."""
    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


def _append_arg(fn, last, *args):
    """fn(*args, last): a kernel or plain version with its chunk_rows."""
    return fn(*args, last)


def to_stack(bins, chunk_rows: int, bits: int):
    """The (n_chunks, F, words_per_chunk) chunk stack of dense (n, F) bins
    at `bits`, each chunk packed on its own and padded with zero words, as
    `ExternalDMatrix` stacks them."""
    import torch

    from repro_torch.core.compress import pack

    n, f = bins.shape
    wpc = -(-chunk_rows // (32 // bits))
    stack = torch.zeros((-(-n // chunk_rows), f, wpc), dtype=torch.int32, device=bins.device)
    for c, s in enumerate(range(0, n, chunk_rows)):
        words = pack(bins[s:s + chunk_rows], bits)
        stack[c, :, :words.shape[1]] = words
    return stack


def expect_launches(where: str, got: dict[str, int], want: dict[str, int]) -> None:
    wrong = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if wrong:
        raise SystemExit(f"{where}: launches (got, expected) {wrong}")


def profile_fit(dtrain, name: str = "fit", knobs: dict | None = None,
                fit_kw: dict | None = None) -> None:
    """A further fit (Booster knobs `knobs`, fit keywords `fit_kw`), traced:
    device time by kernel, device busy time against the fit's wall time;
    the table in profile_{name}.txt of the output directory."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import Booster

    knobs = {"n_rounds": ROUNDS, **(knobs or {})}

    def fit():
        Booster(max_depth=DEPTH, max_bins=MAX_BINS, objective="binary:logistic",
                **knobs).fit(dtrain, **(fit_kw or {}))
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    fit()
    untraced = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit()
        traced = time.perf_counter() - t0
    events = prof.key_averages()

    def device_us(e) -> float:
        return float(getattr(e, "self_device_time_total", 0)
                     or getattr(e, "self_cuda_time_total", 0))

    # Only the kernels themselves: an aten op's self device time repeats
    # the time of the kernels it launched.
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise SystemExit("the profiler recorded no device kernels")
    busy = sum(device_us(e) for e in kernels) / 1e6
    top = sorted(kernels, key=device_us, reverse=True)[:12]
    # The fit's histogram and split-scan kernels by name: device time per
    # launch inside a fit, with no host time in it.
    ours = [e for e in kernels if re.search(r"(histogram|split_scan)_?\w*_kernel", e.key)]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"profile_{name}.txt").write_text(
        events.table(sort_by="self_cuda_time_total", row_limit=60) + "\n"
        + events.table(sort_by="self_cpu_time_total", row_limit=40))
    emit({"phase": "profile", "fit": name, **knobs, "fit_s_untraced": untraced,
          "fit_s_traced": traced,
          "device_busy_s": busy, "idle_share_untraced": 1 - busy / untraced,
          "device_kernel_launches": sum(e.count for e in kernels),
          "top": [{"name": e.key[:90], "device_ms": device_us(e) / 1e3,
                   "calls": e.count} for e in top],
          "port_kernels": [{"name": e.key[:90], "device_ms": device_us(e) / 1e3,
                            "calls": e.count, "us_per_call": device_us(e) / e.count}
                           for e in ours]})


def mslr_shaped(rng, n_queries: int, total: int | None, first_qid: int, signal, thresholds):
    """Rows of MSLR-WEB10K's shape from `rng`: query sizes log-normal (median
    RANK_MEDIAN, sigma RANK_SIGMA), rounded, clipped to 1..RANK_MAX_QUERY and,
    with `total`, moved a row at a time until they sum to it; RANK_FEATURES
    standard normal features; relevance 0-4 from a hidden score (`signal`
    weights on the features, a per-query offset, noise) cut at `thresholds`
    (None: at the quantiles of RANK_SHARES, returned). Rows shuffled, so a
    query's rows are not contiguous. Returns x, relevance, query ids, sizes,
    thresholds."""
    import numpy as np

    sizes = np.clip(np.round(rng.lognormal(np.log(RANK_MEDIAN), RANK_SIGMA, n_queries)),
                    1, RANK_MAX_QUERY).astype(np.int64)
    while total is not None and sizes.sum() != total:
        step = 1 if sizes.sum() < total else -1
        pick = rng.permutation(n_queries)[:min(abs(total - int(sizes.sum())), n_queries)]
        moved = sizes[pick] + step
        sizes[pick] = np.where((moved >= 1) & (moved <= RANK_MAX_QUERY), moved, sizes[pick])
    n = int(sizes.sum())
    qid = np.repeat(np.arange(first_qid, first_qid + n_queries, dtype=np.int32), sizes)
    x = rng.standard_normal((n, RANK_FEATURES), dtype=np.float32)
    offset = rng.normal(size=n_queries).astype(np.float32)
    hidden = x @ signal + 0.5 * np.repeat(offset, sizes) + 0.7 * rng.standard_normal(
        n, dtype=np.float32)
    if thresholds is None:
        thresholds = np.quantile(hidden, np.cumsum(RANK_SHARES)[:-1])
    rel = np.searchsorted(thresholds, hidden).astype(np.float32)
    perm = rng.permutation(n)
    return x[perm], rel[perm], qid[perm], sizes, thresholds


def pair_counts(rel, qid) -> tuple[int, int]:
    """(unordered pairs within the queries, sum of g (g - 1) / 2; unordered
    pairs whose labels differ) of this data. One sigmoid of a pair gives
    both rows' terms, so these are the function's counts, as the kernel
    computes them: each pair once."""
    import numpy as np

    per_query = np.bincount(qid - qid.min()).astype(np.int64)
    per_label = np.bincount((qid - qid.min()).astype(np.int64) * 5 + rel.astype(np.int64),
                            minlength=per_query.shape[0] * 5).astype(np.int64)
    pairs = int((per_query * (per_query - 1)).sum()) // 2
    same = int((per_label * (per_label - 1)).sum()) // 2
    return pairs, pairs - same


def grouped_pair_counts(labels, grouping) -> tuple[int, int]:
    """`pair_counts` of labels 0-4 on the card under an `ops.query_groups`
    grouping (order, start, end)."""
    import numpy as np

    order, start, end = (t.cpu().numpy().astype(np.int64) for t in grouping)
    rel = labels.cpu().numpy().astype(np.int64)[order]
    pairs = int((end - start - 1).sum()) // 2
    per_label = np.bincount(start * 5 + rel).astype(np.int64)
    return pairs, pairs - int((per_label * (per_label - 1)).sum()) // 2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000,
                    help="training rows (the paper's Higgs run has 11,000,000)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace further fits with torch.profiler (the default, "
                         "the dense default, 40 rounds with and without the evals, "
                         "subsample=0.5, the streamed default, the 2-shard default): "
                         "device time by kernel and the device's idle share "
                         "(tables profile_*.txt in the output directory)")
    args = ap.parse_args()

    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on the card", file=sys.stderr)
        return 1
    import numpy as np

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.checkpoint import CheckpointError, load_booster_with_resume
    from repro_torch.core import Booster, DeviceDMatrix, ExternalDMatrix
    from repro_torch.core import metrics as M
    from repro_torch.core import objectives as O
    from repro_torch.core import sampling as SMP
    from repro_torch.core.compress import pack, unpack
    from repro_torch.core.predict import (
        ENSEMBLE_FIELDS,
        slice_rounds,
        traverse_tree_packed,
        truncate_rounds,
    )
    from repro_torch.core.resilience import ChunkIntegrityError, NumericError
    from repro_torch import dist as D
    from repro_torch.core.tree import _histograms_by_subtraction
    from repro_torch.core.histogram import (
        finalize_slab_histogram,
        histogram_chunk_update,
        histogram_rows_chunk_update,
        new_slab,
        node_sums,
        slab_exponent,
    )
    from repro_torch.data import make_dataset
    from repro_torch.kernels import build as KB
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.decompress import decompress
    from repro_torch.kernels.ensemble_traversal import (
        THREADS as TRAVERSAL_THREADS,
        ensemble_margins_kernel,
        node_fields,
        pack_nodes,
        traversal_plan,
    )
    from repro_torch.kernels import fixed as FX
    from repro_torch.kernels.histogram import (
        MIN_BLOCKS_PER_SM,
        build_histograms_packed_kernel,
        build_histograms_rows_kernel,
        dequantise_kernel,
        device_kernels,
        fixed_exponent,
        histogram_packed,
        launch_plan,
        occupancy,
        private_plan,
    )
    from repro_torch.kernels import pairwise as KP
    from repro_torch.kernels.pairwise import pairwise_grad
    from repro_torch.kernels.quantile_cuts import quantile_cuts_from_sorted
    from repro_torch.kernels.split_scan import split_scan
    from repro_torch.serve import PredictEngine, export_xgboost_json, import_xgboost_json
    from repro_torch.serve.engine import DEFAULT_BUCKETS
    from repro_torch.testing import faults

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- 1. device ---------------------------------------------------------
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    # --- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _, info = KB.library()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "nvcc_seconds": round(info.seconds, 3), "library": info.path.name,
          "ptxas": ptxas_summary(info.ptxas)})

    # --- 3. main path --------------------------------------------------------
    x, y, _ = make_dataset("higgs", args.rows + HELD_OUT, seed=args.seed)
    x_tr, y_tr, x_te, y_te = x[:args.rows], y[:args.rows], x[args.rows:], y[args.rows:]
    booster_kw = dict(n_rounds=ROUNDS, max_depth=DEPTH, max_bins=MAX_BINS,
                      objective="binary:logistic")

    def accuracy(prob, labels=y_te) -> float:
        if prob.shape != (HELD_OUT,) or not bool(torch.isfinite(prob).all()):
            raise SystemExit(f"predictions are not {HELD_OUT} finite values")
        return float(((prob.cpu().numpy() > 0.5) == labels).mean())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    dtrain = DeviceDMatrix(x_tr, label=y_tr)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    bst = Booster(**booster_kw).fit(dtrain)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    prob = bst.predict(x_te)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = ops.launches()
    peak = torch.cuda.max_memory_allocated()
    acc = accuracy(prob)

    def host_s(fn) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    # Where predict_s goes: the held-out rows' copy to the card, against a
    # warm predict from numpy and one from rows already on the card.
    predict_parts = {"predict_warm_s": host_s(lambda: bst.predict(x_te)),
                     "row_copy_s": host_s(lambda: torch.as_tensor(x_te, device=dev))}
    xte_dev = torch.as_tensor(x_te, device=dev)
    predict_parts["predict_rows_on_card_s"] = host_s(lambda: bst.predict(xte_dev))
    # The same model in bin space on a ref= matrix: x <= threshold exactly
    # when bin <= split_bin, so both traversals reach the same leaves.
    binned = bst.predict_margins(DeviceDMatrix(x_te, ref=dtrain))
    raw = bst.predict_margins(x_te)
    bin_err = float((binned - raw).abs().max())
    emit({"phase": "main", "rows": args.rows, "features": int(x.shape[1]),
          "bits": dtrain.bits, "rounds": ROUNDS, "max_depth": DEPTH,
          "max_bins": MAX_BINS, "build_s": t1 - t0, "fit_s": t2 - t1,
          "predict_s": t3 - t2, **predict_parts, "held_out_accuracy": acc,
          "binned_vs_raw_max_err": bin_err, "max_memory_allocated": peak,
          "launches": launches})
    if acc <= 0.7:
        raise SystemExit(f"held-out accuracy {acc} does not beat 0.7")
    if bin_err > 1e-5:  # leaves summed in another order: float32 rounding
        raise SystemExit(f"raw and bin-space margins differ by {bin_err}")
    expect_launches("main path", launches, {**path_launches(), "quantile_cuts": 1,
                                            "ensemble_traversal": 1})
    # Every histogram call of the main fit computes its own exponent: one
    # exponent kernel a call (which also zeroes the call's accumulator).
    expect_launches("main path", launches, {"fixed_exponent": launches["histogram_private"]
                                            + launches["histogram_rows"]})

    # --- 4. further fits on the same matrix -----------------------------------
    ens = bst.ensemble

    def same_structure(a, b) -> float:
        """Share of trees whose structure is the same in two models: rounding
        in another order may flip a near-tied split, and the trees after it
        follow other gradients."""
        same = torch.ones(a.n_trees, dtype=torch.bool, device=dev)
        for fld in ("feature", "split_bin", "default_left", "is_leaf"):
            same &= (getattr(a, fld) == getattr(b, fld)).all(dim=1)
        return float(same.float().mean())

    def same_model(a, b, x_=x_te) -> bool:
        """Two boosters bit for bit: every ensemble field, and `predict` on
        the held-out rows (the default: the main rows')."""
        return (all(torch.equal(getattr(a.ensemble, fld), getattr(b.ensemble, fld))
                    for fld in ENSEMBLE_FIELDS)
                and torch.equal(a.predict(x_), b.predict(x_)))

    def same_margins(a, b) -> bool:
        """The training margins bit for bit (both dropped counts as equal)."""
        if a.margins is None or b.margins is None:
            return a.margins is None and b.margins is None
        return torch.equal(a.margins, b.margins)

    fitted = {"default": (bst, acc)}
    for name, knobs in FITS.items():
        ops.reset_launches()
        t0 = time.perf_counter()
        other = Booster(**booster_kw, **knobs).fit(dtrain)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = ops.launches()
        line = {"phase": "fit", "fit": name, **knobs, "fit_s": fit_s,
                "held_out_accuracy": accuracy(other.predict(x_te)),
                "launches": fit_launches}
        fitted[name] = (other, line["held_out_accuracy"])
        if name == "kernel":
            # A reading, not a gate: the kernel path builds every level in
            # full, the default takes a sibling as parent - child in float32,
            # so the two add other floats even from the same integers.
            line["trees_same_structure_as_main"] = same_structure(ens, other.ensemble)
        elif name == "lossguide":
            leaves = other.ensemble.is_leaf.sum(dim=1)
            line["leaves_per_tree_max"] = int(leaves.max())
            if int(leaves.max()) > knobs["max_leaves"]:
                raise SystemExit(f"lossguide grew {int(leaves.max())} leaves")
        emit(line)
        if line["held_out_accuracy"] <= 0.7:
            raise SystemExit(f"{name} fit: held-out accuracy does not beat 0.7")
        expect_launches(f"{name} fit", fit_launches,
                        path_launches(knobs.get("use_kernel_histograms", False)))

    pair_s: dict[str, list[float]] = {"default": [], "kernel": []}
    for i in range(FIT_PAIRS):
        for name in ("default", "kernel") if i % 2 == 0 else ("kernel", "default"):
            t0 = time.perf_counter()
            Booster(**booster_kw, **FITS.get(name, {})).fit(dtrain)
            torch.cuda.synchronize()
            pair_s[name].append(time.perf_counter() - t0)
    med = {k: sorted(v)[FIT_PAIRS // 2] for k, v in pair_s.items()}
    flat_median_s = med["default"]
    emit({"phase": "fit_pairs", "fit_s": pair_s, "median_default_s": med["default"],
          "median_kernel_s": med["kernel"],
          "default_over_kernel": med["default"] / med["kernel"],
          "default_slower_in_pairs": sum(d > k for d, k in zip(pair_s["default"],
                                                               pair_s["kernel"]))})

    # --- 5. the dense fit (compress_matrix=False) ----------------------------
    dense_launches = {}
    for name in ("default", "kernel"):
        knobs = {"compress_matrix": False, **FITS.get(name, {})}
        ops.reset_launches()
        t0 = time.perf_counter()
        other = Booster(**booster_kw, **knobs).fit(dtrain)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        dense_launches[name] = ops.launches()
        packed_bst, packed_acc = fitted[name]
        line = {"phase": "dense", "fit": name, **knobs, "fit_s": fit_s,
                "held_out_accuracy": accuracy(other.predict(x_te)),
                "launches": dense_launches[name]}
        line["accuracy_minus_packed"] = line["held_out_accuracy"] - packed_acc
        line["trees_same_structure_as_packed"] = same_structure(packed_bst.ensemble,
                                                                other.ensemble)
        # The dense scatter (int64 index_add_) and the packed kernels add the
        # same integers at the same exponent: the same fit, bit for bit.
        line["bit_for_bit_packed"] = same_model(packed_bst, other)
        emit(line)
        if line["held_out_accuracy"] <= 0.7:
            raise SystemExit(f"dense {name} fit: held-out accuracy does not beat 0.7")
        if not line["bit_for_bit_packed"]:
            raise SystemExit(f"dense {name} fit differs from the packed fit")
        expect_launches(f"dense {name} fit", dense_launches[name],
                        {**path_launches(name == "kernel", dense=True), "decompress": 1})

    dense_s: dict[str, list[float]] = {"dense": [], "packed": []}
    for i in range(DENSE_PAIRS):
        for name in ("dense", "packed") if i % 2 == 0 else ("packed", "dense"):
            t0 = time.perf_counter()
            Booster(**booster_kw, compress_matrix=name == "packed").fit(dtrain)
            torch.cuda.synchronize()
            dense_s[name].append(time.perf_counter() - t0)
    med = {k: sorted(v)[DENSE_PAIRS // 2] for k, v in dense_s.items()}
    emit({"phase": "dense_pairs", "fit_s": dense_s, "median_dense_s": med["dense"],
          "median_packed_s": med["packed"], "dense_over_packed": med["dense"] / med["packed"]})

    # --- 6. evals, early stopping, iteration_range, update ---------------------
    dvalid = DeviceDMatrix(x_te, label=y_te, ref=dtrain)
    eval_kw = dict(evals=[(dvalid, "valid")], eval_metric=["logloss", "auc"],
                   early_stopping_rounds=EARLY_STOP)
    ops.reset_launches()
    t0 = time.perf_counter()
    es = Booster(**{**booster_kw, "n_rounds": EVAL_ROUNDS}).fit(dtrain, **eval_kw)
    torch.cuda.synchronize()
    es_s = time.perf_counter() - t0
    es_launches = ops.launches()
    ran = len(es.history)  # every round run is recorded, kept or not
    t0 = time.perf_counter()
    Booster(**{**booster_kw, "n_rounds": ran}).fit(dtrain)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    # The history's reading at the best round against an independent eval
    # of the model of best_iteration + 1 rounds: the final model when early
    # stopping cut it there.
    best = es.best_iteration
    at_best = copy.copy(es)
    at_best.ensemble = truncate_rounds(es.ensemble, best + 1)
    eval_auc = at_best.eval(dvalid, "valid", metrics=["auc"])["valid_auc"]
    hist_auc = es.history[best]["valid_auc"]
    # Host reads that the evals add: synchronising calls of a fit with the
    # evals less those of the same rounds without them.
    syncs_evals = count_syncs(lambda: Booster(**{**booster_kw, "n_rounds": EVAL_ROUNDS})
                              .fit(dtrain, **eval_kw))
    syncs_plain = count_syncs(lambda: Booster(**{**booster_kw, "n_rounds": ran}).fit(dtrain))
    # predict(iteration_range=) against the plain traversal of the sliced
    # model on the same rows: the same leaves summed in the same order.
    xte_dev = torch.as_tensor(x_te, device=dev)
    part = slice_rounds(bst.ensemble, *ITERATION_RANGE)
    plain_part = ref.ensemble_margins_ref(part.feature, part.threshold, part.default_left,
                                          part.leaf_value, part.is_leaf, xte_dev,
                                          part.n_classes, DEPTH) + part.base_score
    ops.reset_launches()
    got_part = bst.predict_margins(x_te, iteration_range=ITERATION_RANGE)
    range_launches = ops.launches()["ensemble_traversal"]
    range_exact = bool(torch.equal(got_part, plain_part)) and bool(torch.equal(
        bst.predict(x_te, iteration_range=ITERATION_RANGE), torch.sigmoid(plain_part[:, 0])))
    # update: fit(6) + update(4) is fit(10) bit for bit, as on the CPU.
    cont = Booster(**{**booster_kw, "n_rounds": 6}).fit(dtrain).update(dtrain, 4)
    update_exact = same_model(cont, bst) and same_margins(cont, bst)
    emit({"phase": "evals", "rounds_max": EVAL_ROUNDS, "early_stopping_rounds": EARLY_STOP,
          "rounds_run": ran, "stopped": es.n_rounds_trained < ran,
          "best_iteration": best, "n_rounds_trained": es.n_rounds_trained,
          "best_score": es.best_score, "fit_s": es_s, "fit_s_same_rounds_no_evals": plain_s,
          "evals_overhead_s": es_s - plain_s, "launches": es_launches,
          "history_valid_auc_at_best": hist_auc, "eval_valid_auc_at_best": eval_auc,
          "syncs_with_evals": syncs_evals, "syncs_without_evals": syncs_plain,
          "syncs_added": syncs_evals - syncs_plain,
          "chunks": -(-ran // EARLY_STOP),
          "iteration_range": list(ITERATION_RANGE), "iteration_range_exact": range_exact,
          "iteration_range_traversal_launches": range_launches,
          "update_trees_same_structure_as_one_fit": same_structure(cont.ensemble, ens),
          "update_margin_max_abs_gap": float((cont.margins - bst.margins).abs().max()),
          "update_bit_for_bit_one_fit": update_exact})
    if not update_exact:
        raise SystemExit("fit(6) + update(4) differs from fit(10)")
    if abs(hist_auc - eval_auc) > 1e-5:
        raise SystemExit(f"history's valid_auc {hist_auc} at the best round differs from "
                         f"eval's {eval_auc}")
    if not range_exact or range_launches != 1:
        raise SystemExit("predict(iteration_range=) differs from the plain traversal "
                         "of the sliced model")
    expect_launches("evals fit", es_launches, {
        **{k: v * ran // ROUNDS for k, v in path_launches().items()},
        "ensemble_traversal": 0, "decompress": 0})

    # Early stopping that fires (the repair of a stop never seen on the
    # card): a high learning rate on a slice of the rows overfits within a
    # few rounds, so the held-out logloss turns and the fit stops early.
    d_es = DeviceDMatrix(x_tr[:ES_ROWS], label=y_tr[:ES_ROWS])
    dv_es = DeviceDMatrix(x_te, label=y_te, ref=d_es)
    es2 = Booster(**{**booster_kw, **ES_KNOBS}).fit(
        d_es, evals=[(dv_es, "valid")], eval_metric="logloss",
        early_stopping_rounds=ES_PATIENCE)
    es2_ran, es2_kept = len(es2.history), es2.num_boosted_rounds()
    es2_ens = es2.ensemble
    plain_es = ref.ensemble_margins_ref(es2_ens.feature, es2_ens.threshold,
                                        es2_ens.default_left, es2_ens.leaf_value,
                                        es2_ens.is_leaf, xte_dev, 1,
                                        ES_KNOBS["max_depth"]) + es2_ens.base_score
    es2_exact = (bool(torch.equal(es2.predict_margins(x_te), plain_es))
                 and bool(torch.equal(es2.predict(x_te), torch.sigmoid(plain_es[:, 0]))))
    es2_line = {"phase": "evals", "early_stop": {**ES_KNOBS, "rows": ES_ROWS},
                "patience": ES_PATIENCE, "rounds_run": es2_ran,
                "best_iteration": es2.best_iteration, "rounds_kept": es2_kept,
                "n_trees": es2_ens.n_trees, "nodes_trees": int(es2_ens.nodes.shape[0]),
                "margins_dropped": es2.margins is None, "predict_exact": es2_exact,
                "valid_logloss": [h["valid_logloss"] for h in es2.history]}
    emit(es2_line)
    if not (es2_kept < es2_ran and es2_kept == es2.best_iteration + 1
            and es2_ens.n_trees == es2_ens.nodes.shape[0] == es2_kept
            and es2.margins is None and es2_exact):
        raise SystemExit(f"early stopping on the card: {es2_line}")
    del d_es, dv_es

    # --- 7. the objective registry --------------------------------------------
    rng = np.random.default_rng(args.seed)
    z = np.nan_to_num(x)
    signal = z[:, 0] - 0.5 * z[:, 1] + 0.4 * z[:, 2] * z[:, 3] + 0.3 * z[:, 4]
    targets = {
        "reg:quantile": signal + (0.5 + np.abs(z[:, 5])) * rng.normal(size=len(z)),
        "reg:pseudohubererror": signal + rng.standard_t(2, size=len(z)),
        "count:poisson": rng.poisson(np.exp(np.clip(0.5 * signal, -4, 3))),
    }
    obj_lines = {}
    for objective, target in targets.items():
        yt = target.astype(np.float32)
        d_obj = DeviceDMatrix(x_tr, label=yt[:args.rows], ref=dtrain)
        knobs = {**booster_kw, "objective": objective, "quantile_alpha": QUANTILE_ALPHA}
        ops.reset_launches()
        t0 = time.perf_counter()
        fitted_obj = Booster(**knobs).fit(d_obj)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        obj_launches = ops.launches()
        metric = M.get_metric(O.get_objective(objective).default_metric)
        y_held = torch.as_tensor(yt[args.rows:], device=dev)
        held = fitted_obj.predict_margins(x_te)
        const = torch.full_like(held, fitted_obj.base_score)
        extra = O.config_kwargs(fitted_obj.cfg)
        model_m = float(metric.fn(held, y_held, **extra))
        const_m = float(metric.fn(const, y_held, **extra))
        obj_lines[objective] = {"fit_s": fit_s, "metric": metric.name, "held_out": model_m,
                                "constant": const_m, "base_score": fitted_obj.base_score,
                                "launches": obj_launches}
        if not model_m < const_m:
            raise SystemExit(f"{objective}: held-out {metric.name} {model_m} does not beat "
                             f"the constant baseline's {const_m}")
        expect_launches(f"{objective} fit", obj_launches, path_launches())
        del d_obj

    def logistic_copy(margins, y):
        p = torch.sigmoid(margins[:, 0])
        return p - y, p * (1.0 - p)

    custom = O.register_objective("smoke:logistic_copy", logistic_copy,
                                  transform=lambda m: torch.sigmoid(m[:, 0]),
                                  default_metric="accuracy", overwrite=True)
    ops.reset_launches()
    t0 = time.perf_counter()
    bst_custom = Booster(**booster_kw).fit(dtrain, obj=custom)
    torch.cuda.synchronize()
    custom_s = time.perf_counter() - t0
    custom_launches = ops.launches()
    custom_acc = accuracy(bst_custom.predict(x_te))
    custom_same = same_structure(ens, bst_custom.ensemble)
    custom_exact = same_model(bst_custom, bst)
    grad_exact = bool(torch.equal(custom.grad(bst.margins, dtrain.label),
                                  O.logistic.grad(bst.margins, dtrain.label)))
    emit({"phase": "objectives", "rounds": ROUNDS, "quantile_alpha": QUANTILE_ALPHA,
          "main_fit_s": t2 - t1, **obj_lines,
          "custom": {"objective": bst_custom.cfg.objective, "fit_s": custom_s,
                     "grad_bit_for_bit": grad_exact,
                     "held_out_accuracy": custom_acc, "main_accuracy": acc,
                     "trees_same_structure_as_main": custom_same,
                     "bit_for_bit_main": custom_exact,
                     "launches": custom_launches}})
    if abs(custom_acc - acc) > 0.003 or not grad_exact or not custom_exact:
        raise SystemExit(f"the registered copy of binary:logistic: accuracy {custom_acc} "
                         f"against {acc}, gradient bit for bit: {grad_exact}, model bit "
                         f"for bit: {custom_exact}")
    expect_launches("custom objective fit", custom_launches, path_launches())

    # --- 8. persistence -------------------------------------------------------
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    path = str(work / "main.ckpt")
    t0 = time.perf_counter()
    bst.save(path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = Booster.load(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    persist_exact = bool(torch.equal(loaded.predict(x_te), prob))
    loaded.save(str(work / "again.ckpt"))
    same_bytes = (work / "again.ckpt").read_bytes() == Path(path).read_bytes()
    ref_bst = Booster.load(str(REFERENCE_CKPT))
    ref_rows = np.load(REFERENCE_CKPT.with_name(REFERENCE_CKPT.stem + "_rows.npy"))
    ref_pred = np.load(REFERENCE_CKPT.with_name(REFERENCE_CKPT.stem + "_pred.npy"))
    ref_err = float(np.abs(ref_bst.predict(ref_rows).cpu().numpy() - ref_pred).max())
    raw = bytearray(Path(path).read_bytes())
    raw[len(raw) // 2] ^= 0x01  # one payload byte flipped
    (work / "corrupt.ckpt").write_bytes(bytes(raw))
    try:
        Booster.load(str(work / "corrupt.ckpt"))
        corrupt_raises = False
    except CheckpointError:
        corrupt_raises = True
    # The same model through XGBoost JSON: thresholds go one ulp up and come
    # back, so the imported arenas predict bit for bit.
    imported = import_xgboost_json(export_xgboost_json(bst))
    ops.reset_launches()
    json_exact = bool(torch.equal(imported.predict_margins(x_te), bst.predict_margins(x_te)))
    json_launches = ops.launches()["ensemble_traversal"]
    emit({"phase": "persist", "file_bytes": Path(path).stat().st_size, "save_s": save_s,
          "load_s": load_s, "predict_exact_after_load": persist_exact,
          "save_load_save_same_bytes": same_bytes,
          "reference_checkpoint": REFERENCE_CKPT.name,
          "reference_max_abs_err": ref_err, "reference_tolerance": REFERENCE_ATOL,
          "corrupt_raises": corrupt_raises, "xgboost_json_exact": json_exact,
          "xgboost_json_traversal_launches": json_launches})
    if not (persist_exact and same_bytes and corrupt_raises and json_exact
            and json_launches == 2):
        raise SystemExit("persist phase failed (see its line)")
    if ref_err > REFERENCE_ATOL:
        raise SystemExit(f"the reference checkpoint predicts {ref_err} off its stored "
                         f"predictions (tolerance {REFERENCE_ATOL})")

    # --- 9. serving -------------------------------------------------------------
    t0 = time.perf_counter()
    served_fit = Booster(**{**booster_kw, "n_rounds": SERVED_ROUNDS}).fit(dtrain)
    torch.cuda.synchronize()
    served_fit_s = time.perf_counter() - t0
    served_fit.save(str(work / "served.ckpt"))
    served = Booster.load(str(work / "served.ckpt"))
    del served_fit
    pageable_s = [host_s(lambda: torch.as_tensor(x_te, device=dev)) for _ in range(20)]
    pinned_x = torch.from_numpy(x_te).pin_memory()
    pinned_s = [host_s(lambda: pinned_x.to(dev, non_blocking=True)) for _ in range(20)]
    # The host's share of a 100k request in the engine: its validation pass
    # and its copies into top-bucket staging.
    top_rows = DEFAULT_BUCKETS[-1]
    staging_np = torch.empty((top_rows, x_te.shape[1]), pin_memory=True).numpy()

    def stage_all():
        for s in range(0, HELD_OUT, top_rows):
            part = x_te[s:s + top_rows]
            np.copyto(staging_np[:len(part)], part, casting="unsafe")

    isinf_s = sorted(host_s(lambda: np.isinf(x_te).any()) for _ in range(20))
    stage_s = sorted(host_s(stage_all) for _ in range(20))
    serve_lines = {}
    for label, model in (("served", served), ("main", loaded)):
        want = {n: model.predict(x_te[:n]).cpu().numpy() for n in SERVE_SIZES}
        ops.reset_launches()
        eng = PredictEngine(model).warmup()
        warm_launches = ops.launches()["ensemble_traversal"]
        warm_traces = eng.trace_count
        eng.reset_stats()
        ops.reset_launches()
        exact = True
        for _ in range(3):
            for n in SERVE_SIZES:
                exact &= bool(np.array_equal(eng.predict(x_te[:n]), want[n]))
        stream_launches = ops.launches()["ensemble_traversal"]
        stream_traces = eng.trace_count - warm_traces
        per_size = {}
        for n in SERVE_SIZES:
            eng.reset_stats()
            for _ in range(SERVE_REPEATS):
                eng.predict(x_te[:n])
            st = eng.stats()
            bp = sorted(host_s(lambda: model.predict(x_te[:n]).cpu().numpy())
                        for _ in range(SERVE_REPEATS))
            per_size[n] = {"p50_ms": st["p50_ms"], "p99_ms": st["p99_ms"],
                           "rows_per_s": st["rows_per_s"],
                           "booster_predict_p50_ms": bp[len(bp) // 2] * 1e3,
                           "booster_predict_p99_ms": bp[int(0.99 * (len(bp) - 1))] * 1e3}
        line = {"trees": model.ensemble.n_trees, "buckets": len(DEFAULT_BUCKETS),
                "warmup_traversal_launches": warm_launches, "trace_count": warm_traces,
                "stream_traversal_launches": stream_launches,
                "stream_new_traces": stream_traces, "stream_exact": exact,
                "per_size": per_size}
        if label == "served":
            variants = {}
            for kw_e, kw_p in (({"output_margin": True}, {"output_margin": True}),
                               ({"iteration_range": SERVE_RANGE},
                                {"iteration_range": SERVE_RANGE})):
                eng_v = PredictEngine(model, **kw_e)
                variants[next(iter(kw_e))] = all(
                    np.array_equal(eng_v.predict(x_te[:n]),
                                   model.predict(x_te[:n], **kw_p).cpu().numpy())
                    for n in (17, 8193, HELD_OUT))
            bad = x_te[:4].copy()
            bad[0, 0] = np.inf
            try:
                eng.predict(bad)
                inf_raises = False
            except ValueError as exc:
                inf_raises = "infinite feature values" in str(exc)
            line.update(fit_s=served_fit_s, variants_exact=variants, inf_raises=inf_raises)
            exact &= all(variants.values()) and inf_raises
        serve_lines[label] = line
        if not (exact and warm_launches == warm_traces == len(DEFAULT_BUCKETS)
                and stream_launches == 0 and stream_traces == 0):
            raise SystemExit(f"serve phase ({label}) failed: {line}")
        del eng
    emit({"phase": "serve", "sizes": list(SERVE_SIZES), "repeats": SERVE_REPEATS,
          "copy_100k_pageable_ms": sorted(pageable_s)[10] * 1e3,
          "copy_100k_pinned_ms": sorted(pinned_s)[10] * 1e3,
          "isinf_check_100k_ms": isinf_s[10] * 1e3, "staging_copies_100k_ms": stage_s[10] * 1e3,
          **serve_lines})
    del served, pinned_x, staging_np

    # --- 10. ranking: an MSLR-WEB10K-shaped rank:pairwise fit -------------------
    rank_rng = np.random.default_rng(args.seed + 1)
    signal = (rank_rng.normal(size=RANK_FEATURES) * (np.arange(RANK_FEATURES) < 24)
              / np.sqrt(24)).astype(np.float32)
    xr, yr, qr, sizes, cuts_r = mslr_shaped(rank_rng, RANK_QUERIES, RANK_ROWS, 0, signal, None)
    xrv, yrv, qrv, sizes_v, _ = mslr_shaped(rank_rng, RANK_HELD_QUERIES, None, RANK_QUERIES,
                                            signal, cuts_r)
    pairs, differ = pair_counts(yr, qr)
    t0 = time.perf_counter()
    d_rank = DeviceDMatrix(xr, label=yr, group_ids=qr)
    d_rank_v = DeviceDMatrix(xrv, label=yrv, group_ids=qrv, ref=d_rank)
    torch.cuda.synchronize()
    rank_build_s = time.perf_counter() - t0
    rank_kw = {**booster_kw, "objective": "rank:pairwise"}
    rank_evals = dict(evals=[(d_rank_v, "valid")], eval_metric=["ndcg@10"])
    ops.reset_launches()
    t0 = time.perf_counter()
    rank_bst = Booster(**rank_kw).fit(d_rank, **rank_evals)
    torch.cuda.synchronize()
    rank_fit_s = time.perf_counter() - t0
    rank_launches = ops.launches()
    t0 = time.perf_counter()
    Booster(**rank_kw).fit(d_rank)
    torch.cuda.synchronize()
    rank_fit_no_evals_s = time.perf_counter() - t0
    held_ndcg = rank_bst.eval(d_rank_v, "valid")["valid_ndcg@10"]
    hist_ndcg = rank_bst.history[-1]["valid_ndcg@10"]
    ndcg10 = M.get_metric("ndcg@10").fn
    zero_ndcg = float(ndcg10(torch.zeros((d_rank_v.n_rows, 1), device=dev), d_rank_v.label,
                             group_ids=d_rank_v.group_ids))
    # ndcg@10 of the model's held-out margins on the card against the same
    # sorts on the CPU.
    held_m = rank_bst.predict_margins(d_rank_v)
    ndcg_card = float(ndcg10(held_m, d_rank_v.label, group_ids=d_rank_v.group_ids))
    ndcg_cpu = float(ndcg10(held_m.cpu(), d_rank_v.label.cpu(),
                            group_ids=d_rank_v.group_ids.cpu()))
    # The grouping adds no synchronising call to the round loop, and the
    # grouped metric none beyond a plain metric's one read a chunk: against
    # the main fit with and without one eval set.
    syncs = {
        "rank_evals": count_syncs(lambda: Booster(**rank_kw).fit(d_rank, **rank_evals)),
        "rank": count_syncs(lambda: Booster(**rank_kw).fit(d_rank)),
        "main_evals": count_syncs(lambda: Booster(**booster_kw).fit(
            dtrain, evals=[(dvalid, "valid")], eval_metric=["logloss"])),
        "main": count_syncs(lambda: Booster(**booster_kw).fit(dtrain)),
    }
    rank_bst.save(str(work / "rank.ckpt"))
    rank_loaded = Booster.load(str(work / "rank.ckpt"))
    rank_persist_exact = bool(torch.equal(rank_loaded.predict(xrv), rank_bst.predict(xrv)))
    rank_line = {
        "phase": "rank", "rows": int(len(yr)), "queries": RANK_QUERIES,
        "features": RANK_FEATURES, "query_rows_min": int(sizes.min()),
        "query_rows_mean": float(sizes.mean()), "query_rows_max": int(sizes.max()),
        "sum_g2": int((sizes.astype(np.int64) ** 2).sum()), "pairs": pairs,
        "pairs_labels_differ": differ,
        "label_shares": np.bincount(yr.astype(np.int64), minlength=5).tolist(),
        "held_out_rows": int(len(yrv)), "held_out_queries": RANK_HELD_QUERIES,
        "build_s": rank_build_s, "fit_s": rank_fit_s, "fit_s_no_evals": rank_fit_no_evals_s,
        "main_fit_s": t2 - t1, "main_warm_fit_s": sorted(pair_s["default"])[FIT_PAIRS // 2],
        "launches": rank_launches, "held_out_ndcg10": held_ndcg,
        "history_ndcg10": hist_ndcg, "all_zero_ndcg10": zero_ndcg,
        "ndcg10_card_minus_cpu": ndcg_card - ndcg_cpu, "syncs": syncs,
        "persist_exact": rank_persist_exact}
    emit(rank_line)
    expect_launches("rank fit", rank_launches, {**path_launches(), "pairwise_grad": ROUNDS,
                                                "ensemble_traversal": 0, "decompress": 0})
    if not held_ndcg > zero_ndcg:
        raise SystemExit(f"held-out ndcg@10 {held_ndcg} does not beat the all-zero "
                         f"model's {zero_ndcg}")
    if abs(hist_ndcg - held_ndcg) > 1e-5 or abs(ndcg_card - ndcg_cpu) > 1e-6:
        raise SystemExit(f"ndcg@10: history {hist_ndcg}, eval {held_ndcg}, card "
                         f"{ndcg_card}, cpu {ndcg_cpu}")
    if syncs["rank"] > syncs["main"] or (
            syncs["rank_evals"] - syncs["rank"] > syncs["main_evals"] - syncs["main"]):
        raise SystemExit(f"the rank fit adds synchronising calls: {syncs}")
    if not rank_persist_exact:
        raise SystemExit("the rank model predicts otherwise after save and load")
    # The check phase's training scores: after RANK_CHECK_ROUNDS rounds.
    rank_scores = Booster(**{**rank_kw, "n_rounds": RANK_CHECK_ROUNDS}).fit(
        d_rank).margins[:, 0].contiguous()
    del rank_loaded, held_m

    # --- 11. the sklearn estimators ------------------------------------------
    from repro_torch import sklearn as SK

    ops.reset_launches()
    t0 = time.perf_counter()
    clf = SK.XGBClassifier(n_estimators=ROUNDS, max_depth=DEPTH, max_bins=MAX_BINS).fit(
        x_tr, y_tr)
    torch.cuda.synchronize()
    clf_fit_s = time.perf_counter() - t0
    clf_launches = ops.launches()
    proba = clf.predict_proba(x_te)
    clf_booster_exact = bool(np.array_equal(proba[:, 1],
                                            clf.get_booster().predict(x_te).cpu().numpy()))
    clf.set_params(serve=True)
    clf_serve_exact = bool(np.array_equal(clf.predict_proba(x_te), proba))
    clf_acc = float((clf.predict(x_te) == y_te).mean())
    rk = SK.XGBRanker(n_estimators=ROUNDS, max_depth=DEPTH, max_bins=MAX_BINS).fit(
        xr, yr, qid=qr)
    rk_exact = bool(np.array_equal(rk.predict(xrv),
                                   rk.get_booster().predict(xrv).cpu().numpy()))
    # group= sizes of the rows sorted by query give those rows' qid= array.
    q_sorted = np.sort(qr, kind="stable")
    _, counts = np.unique(q_sorted, return_counts=True)
    group_is_qid = bool(np.array_equal(SK.XGBRanker._qid(len(qr), None, counts), q_sorted))
    y_reg = targets["reg:quantile"].astype(np.float32)
    reg = SK.XGBRegressor(n_estimators=ROUNDS, max_depth=DEPTH, max_bins=MAX_BINS).fit(
        x_tr, y_reg[:args.rows])
    reg_rmse = float(np.sqrt(np.mean((reg.predict(x_te) - y_reg[args.rows:]) ** 2)))
    const_rmse = float(np.sqrt(np.mean((y_reg[:args.rows].mean() - y_reg[args.rows:]) ** 2)))
    sk_line = {"phase": "sklearn", "have_sklearn": SK.HAVE_SKLEARN,
               "classifier": {"fit_s": clf_fit_s, "launches": clf_launches,
                              "predict_proba_is_booster_predict": clf_booster_exact,
                              "serve_equals_plain": clf_serve_exact,
                              "held_out_accuracy": clf_acc, "main_accuracy": acc},
               "ranker": {"predict_is_booster_predict": rk_exact,
                          "group_sizes_give_qid": group_is_qid},
               "regressor": {"held_out_rmse": reg_rmse, "constant_rmse": const_rmse}}
    emit(sk_line)
    expect_launches("XGBClassifier fit", clf_launches, {**path_launches(), "quantile_cuts": 1})
    if not (clf_booster_exact and clf_serve_exact and abs(clf_acc - acc) <= 0.003
            and rk_exact and group_is_qid and reg_rmse < const_rmse):
        raise SystemExit(f"sklearn phase failed: {sk_line}")
    del clf, rk, reg, xr  # xrv: the repeat phase predicts the rank fit on it

    # --- 12. stochastic and constrained training --------------------------------
    # MONOTONE_LABEL: rises with feature 0, falls with feature 1, and keeps a
    # pairwise term and a linear one of other features, from the seed.
    zm = np.nan_to_num(x)
    mono_signal = (zm[:, 0] - zm[:, 1] + 0.5 * zm[:, 2] * zm[:, 3] + 0.6 * zm[:, 4]
                   + 0.3 * np.random.default_rng(args.seed + 1).standard_normal(len(zm)))
    y_mono = (mono_signal > 0).astype(np.float32)
    d_mono = DeviceDMatrix(x_tr, label=y_mono[:args.rows], ref=dtrain)
    del zm, mono_signal
    stoch_models = {}
    for name, (knobs, want) in STOCH_FITS.items():
        data_, labels_ = (d_mono, y_mono[args.rows:]) if name == "monotone" else (dtrain, y_te)
        ops.reset_launches()
        t0 = time.perf_counter()
        model = Booster(**booster_kw, **knobs).fit(data_)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        got = ops.launches()
        line = {"phase": "stochastic", "fit": name, **knobs, "fit_s": fit_s,
                "held_out_accuracy": accuracy(model.predict(x_te), labels_),
                "main_accuracy": acc, "launches": got}
        if name == "monotone":  # the same label without constraints, beside it
            line["label"] = "MONOTONE_LABEL"
            line["unconstrained_accuracy"] = accuracy(
                Booster(**booster_kw).fit(d_mono).predict(x_te), labels_)
        emit(line)
        stoch_models[name] = model
        if line["held_out_accuracy"] <= 0.7:
            raise SystemExit(f"stochastic {name} fit: held-out accuracy does not beat 0.7")
        expect_launches(f"stochastic {name} fit", got, dict(zip(
            ("histogram_private", "histogram_rows", "split_scan", "decompress"), want)))
    # No host read in the draws and selections: a sampled fit synchronises no
    # more often than the default fit.
    syncs = {name: count_syncs(lambda: Booster(**booster_kw, **knobs).fit(dtrain))
             for name, knobs in (("default", {}), ("subsample", STOCH_FITS["subsample"][0]),
                                 ("goss", STOCH_FITS["goss"][0]))}
    # The monotone sweep: margins (the trees' float sum, monotone in each
    # tree's leaf) along ascending values of each constrained feature.
    sweep = {}
    for feat, sign in ((0, MONOTONE[0]), (1, MONOTONE[1])):
        col = x_te[:, feat]
        grid = np.linspace(np.nanmin(col), np.nanmax(col), SWEEP_STEPS, dtype=np.float32)
        rows = np.repeat(x_te[:SWEEP_ROWS], SWEEP_STEPS, axis=0)
        rows[:, feat] = np.tile(grid, SWEEP_ROWS)
        marg = stoch_models["monotone"].predict(rows, output_margin=True).reshape(
            SWEEP_ROWS, SWEEP_STEPS)
        steps = (marg[:, 1:] - marg[:, :-1]) * sign
        sweep[f"feature_{feat}"] = {"sign": sign, "exact": bool((steps >= 0).all()),
                                    "rows_that_move": int((steps > 0).any(dim=1).sum())}
    # The draws: a function of their path on the card; selections made on
    # the card from uniforms drawn on the CPU equal the CPU's own.
    g_abs = (torch.sigmoid(bst.margins[:, 0]) - torch.as_tensor(y_tr, device=dev)).abs()
    m_top, m_other = SMP.goss_sizes(dtrain.n_rows, SMP.StochasticParams(sampling_method="goss"))

    def selections(seed, device, ga):
        path = (seed, 3, 0)
        ctx = SMP.TreeContext(path, None, None, SMP.StochasticParams(
            colsample_bylevel=0.5, colsample_bynode=0.5), device)
        sel = SMP.row_selection_mask(path, dtrain.n_rows, dtrain.n_rows // 2, device)
        return (sel, SMP.compact_row_ids(sel, dtrain.n_rows // 2),
                *SMP.goss_selection(path, ga, m_top, m_other),
                SMP.level_feature_mask(ctx, 3, 8, dtrain.n_features))

    first, again, other = (selections(s_, dev, g_abs) for s_ in (args.seed, args.seed,
                                                                   args.seed + 1))
    draws_same = all(torch.equal(a_, b_) for a_, b_ in zip(first, again))
    draws_differ = not any(torch.equal(a_, b_) for a_, b_ in zip(first, other))
    card_draw = SMP.uniform
    SMP.uniform = lambda path_, shape, device: card_draw(path_, shape, "cpu").to(device)
    try:
        from_cpu = [t.cpu() for t in selections(args.seed, dev, g_abs)]
        on_cpu = selections(args.seed, "cpu", g_abs.cpu())
    finally:
        SMP.uniform = card_draw
    card_equals_cpu = all(torch.equal(a_, b_) for a_, b_ in zip(from_cpu, on_cpu))
    # save -> load -> predict, the knobs back as they were.
    persisted = {}
    for name in ("tuned", "monotone"):
        path = str(work / f"{name}.ckpt")
        stoch_models[name].save(path)
        back = Booster.load(path)
        persisted[name] = (bool(torch.equal(back.predict(x_te), stoch_models[name].predict(x_te)))
                           and back.cfg == stoch_models[name].cfg)
    persisted["monotone_tuple"] = Booster.load(str(work / "monotone.ckpt")).cfg \
        .monotone_constraints == MONOTONE
    # Warm pairs of subsample=0.5 against the default, alternating; then
    # fit(6) + update(4) against fit(10), bit for bit.
    stoch_s: dict[str, list[float]] = {"subsample": [], "default": []}
    for i in range(STOCH_PAIRS):
        for name in ("subsample", "default") if i % 2 == 0 else ("default", "subsample"):
            t0 = time.perf_counter()
            Booster(**booster_kw, **(STOCH_FITS["subsample"][0] if name == "subsample"
                                     else {})).fit(dtrain)
            torch.cuda.synchronize()
            stoch_s[name].append(time.perf_counter() - t0)
    med = {k: sorted(v)[STOCH_PAIRS // 2] for k, v in stoch_s.items()}
    sub = stoch_models["subsample"]
    cont = Booster(**{**booster_kw, "n_rounds": 6}, **STOCH_FITS["subsample"][0]).fit(
        dtrain).update(dtrain, 4)
    st_line = {"phase": "stochastic", "syncs": syncs, "monotone_sweep": sweep,
               "draws_same_twice": draws_same, "draws_differ_by_seed": draws_differ,
               "card_selections_equal_cpu": card_equals_cpu, "save_load_exact": persisted,
               "pairs_fit_s": stoch_s, "median_subsample_s": med["subsample"],
               "median_default_s": med["default"],
               "subsample_over_default": med["subsample"] / med["default"],
               "update_trees_same_structure_as_one_fit": same_structure(cont.ensemble,
                                                                        sub.ensemble),
               "update_margin_max_abs_gap": float((cont.margins - sub.margins).abs().max()),
               "update_bit_for_bit_one_fit": same_model(cont, sub) and same_margins(cont, sub)}
    emit(st_line)
    if not (syncs["subsample"] <= syncs["default"] and syncs["goss"] <= syncs["default"]
            and all(v["exact"] for v in sweep.values()) and draws_same and draws_differ
            and card_equals_cpu and all(persisted.values())
            and st_line["update_bit_for_bit_one_fit"]):
        raise SystemExit(f"stochastic phase failed: {st_line}")
    del stoch_models, model, sub, cont, first, again, other, from_cpu, on_cpu, g_abs, d_mono

    # --- 13. external memory (resident chunk stack) -----------------------------
    # The main matrix as an ExternalDMatrix with ref= the flat one (its cuts):
    # EXT_CHUNK_ROWS (8 chunks at 1M rows), then EXT_ODD_CHUNK_ROWS (not a
    # multiple of the 4 symbols a word, a short last chunk). Each chunk's
    # words are the flat words of its rows; the chunked default fit launches
    # the flat fit's kernels as often (one launch a level over the stack);
    # predict on the chunks is bit for bit predict on the flat matrix; an
    # ExternalDMatrix eval set's metrics are the flat eval set's.
    dense_bins = unpack(dtrain.matrix.packed, dtrain.bits, args.rows)
    dte = DeviceDMatrix(x_te, label=y_te, ref=dtrain)
    ext_chunk = EXT_CHUNK_ROWS if args.rows <= 2 * EXT_CHUNK_ROWS * 8 else EXT_CHUNK_ROWS_LARGE
    ext_lines, ext_stacks = [], {}
    for chunk_rows in (ext_chunk, EXT_ODD_CHUNK_ROWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dext = ExternalDMatrix.from_arrays(x_tr, y_tr, chunk_rows=chunk_rows, ref=dtrain)
        cpb = dext.packed_bins()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        words_exact = all(
            torch.equal(cpb.packed[c, :, :w_.shape[1]], w_)
            and not bool(cpb.packed[c, :, w_.shape[1]:].any())
            for c, w_ in ((c, pack(dense_bins[c * chunk_rows:(c + 1) * chunk_rows], dext.bits))
                          for c in range(dext.n_chunks)))
        torch.cuda.reset_peak_memory_stats()
        before_fit = torch.cuda.memory_allocated()
        ops.reset_launches()
        t0 = time.perf_counter()
        ebst = Booster(**booster_kw).fit(dext)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        got = ops.launches()
        peak_fit = torch.cuda.max_memory_allocated()
        eacc = accuracy(ebst.predict(x_te))
        predict_exact = bool(torch.equal(ebst.predict_margins(dext), ebst.predict_margins(dtrain)))
        dte_ext = ExternalDMatrix.from_arrays(x_te, y_te, chunk_rows=EXT_EVAL_CHUNK_ROWS,
                                              ref=dtrain)
        evbst = Booster(**booster_kw).fit(dext, evals=[(dte_ext, "valid")],
                                          eval_metric=["logloss", "auc"])
        flat_eval = evbst.eval(dte, "valid", ["logloss", "auc"])
        eval_gap = max(abs(evbst.history[-1][k] - v) for k, v in flat_eval.items())
        # fit_s above is the first chunked fit of its kind (cold); warm,
        # alternating pairs set the chunked fit beside the flat one.
        pairs_s: dict[str, list[float]] = {"chunked": [], "flat": []}
        for i in range(EXT_PAIRS):
            for name in ("chunked", "flat") if i % 2 == 0 else ("flat", "chunked"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                Booster(**booster_kw).fit(dext if name == "chunked" else dtrain)
                torch.cuda.synchronize()
                pairs_s[name].append(time.perf_counter() - t0)
        warm = {k: sorted(v)[EXT_PAIRS // 2] for k, v in pairs_s.items()}
        line = {"phase": "external", "chunk_rows": chunk_rows, "n_chunks": dext.n_chunks,
                "bits": dext.bits, "stack_bytes": dext.nbytes_device,
                "flat_words_bytes": dtrain.matrix.nbytes_compressed(), "build_s": build_s,
                "first_fit_s": fit_s, "flat_fit_warm_median_s": flat_median_s,
                "warm_pairs_fit_s": pairs_s, "median_chunked_warm_s": warm["chunked"],
                "median_flat_warm_s": warm["flat"],
                "chunked_over_flat_warm": warm["chunked"] / warm["flat"],
                "memory_allocated_before_fit": before_fit,
                "fit_peak_above_before": peak_fit - before_fit, "words_exact": words_exact,
                "held_out_accuracy": eacc, "flat_accuracy": acc,
                "trees_same_structure_as_flat": same_structure(ebst.ensemble, ens),
                "bit_for_bit_flat": same_model(ebst, bst),
                "predict_chunks_equal_flat": predict_exact,
                "eval_set_vs_flat_max_gap": eval_gap, "launches": got}
        ext_lines.append(line)
        emit(line)
        expect_launches(f"chunked fit at {chunk_rows} rows a chunk", got, path_launches())
        if not (words_exact and predict_exact and abs(eacc - acc) <= 0.003 and eval_gap <= 1e-5
                and line["bit_for_bit_flat"]):
            raise SystemExit(f"external phase failed: {line}")
        ext_stacks[chunk_rows] = cpb
        del ebst, evbst, dte_ext
    # A sampled chunked fit grows over its compacted rows: the row-id kernel
    # at every level, the root included, as the flat subsample fit.
    ops.reset_launches()
    sbst = Booster(**booster_kw, subsample=0.5).fit(dext)
    got = ops.launches()
    sub_line = {"phase": "external", "fit": "subsample", "chunk_rows": dext.chunk_rows,
                "held_out_accuracy": accuracy(sbst.predict(x_te)), "launches": got}
    emit(sub_line)
    expect_launches("chunked subsample fit", got, dict(zip(
        ("histogram_private", "histogram_rows", "split_scan"), STOCH_FITS["subsample"][1])))
    if sub_line["held_out_accuracy"] <= 0.7:
        raise SystemExit(f"chunked subsample fit: {sub_line}")
    # cuts="sketch" from raw batches of another size (the streaming sketch,
    # each chunk's columns sorted on the card), re-chunked to ext_chunk.
    t0 = time.perf_counter()
    dsk = ExternalDMatrix(((x_tr[s:s + EXT_BATCH_ROWS], y_tr[s:s + EXT_BATCH_ROWS])
                           for s in range(0, args.rows, EXT_BATCH_ROWS)),
                          chunk_rows=ext_chunk, cuts="sketch")
    torch.cuda.synchronize()
    sketch_build_s = time.perf_counter() - t0
    kbst = Booster(**booster_kw).fit(dsk)
    sk_line = {"phase": "external", "fit": "sketch", "build_s": sketch_build_s,
               "held_out_accuracy": accuracy(kbst.predict(x_te)),
               "cuts_equal_compute_cuts_share": float((dsk.cuts == dtrain.cuts).float().mean())}
    emit(sk_line)
    if sk_line["held_out_accuracy"] <= 0.7:
        raise SystemExit(f"sketch-cut chunked fit: {sk_line}")
    del sbst, kbst, dsk, dense_bins
    # Page-in faults on the card, on a fresh matrix of the first rows.
    faulted = {}
    fault_rows = min(FAULT_ROWS, args.rows)
    for name_f, site, arm in (
            ("corrupt_once", "chunk_corrupt", dict(times=1, chunk=1, index=5, bit=3)),
            ("corrupt_always", "chunk_corrupt", dict(times=None, chunk=2, index=9, bit=7)),
            ("load_twice", "chunk_load", dict(error=faults.TransientLoadError, times=2))):
        fresh = ExternalDMatrix.from_arrays(x_tr[:fault_rows], y_tr[:fault_rows],
                                            chunk_rows=-(-fault_rows // FAULT_CHUNKS),
                                            ref=dtrain, load_backoff=0.0)
        with warnings.catch_warnings(record=True) as seen, faults.inject(site, **arm) as spec:
            warnings.simplefilter("always")
            try:
                stack_ = fresh.packed_bins().packed
                err = None
                same = bool((stack_.cpu().numpy().view(np.uint32) == fresh._host_packed).all())
            except ChunkIntegrityError as exc:
                err, same = str(exc), None
        faulted[name_f] = {"fired": spec.fired, "warnings": len(seen), "error": err,
                           "stack_equals_host": same}
    emit({"phase": "external", "faults": faulted})
    if not (faulted["corrupt_once"]["fired"] == 1 and faulted["corrupt_once"]["warnings"] == 1
            and faulted["corrupt_once"]["stack_equals_host"]
            and "chunk(s) [2]" in (faulted["corrupt_always"]["error"] or "")
            and faulted["load_twice"]["fired"] == 2 and faulted["load_twice"]["warnings"] == 2
            and faulted["load_twice"]["stack_equals_host"]):
        raise SystemExit(f"external page-in faults: {faulted}")

    # --- 14. streamed external memory ----------------------------------------------
    # The main matrix as a streamed ExternalDMatrix (ref= the flat matrix):
    # the stack stays on the host and every pass pages it a chunk at a time
    # through the pager's ring (prefetch + 1 pinned and device slots, copies
    # on their own stream), the kernels launched once a chunk. Beside each,
    # a resident chunked fit of the same chunks, its stack paged in by the
    # fit (unloaded before), so its peak memory counts the stack.
    # The phase runs in a function of its own, so that its names never
    # shadow those of the phases after it.
    def stream_phase() -> None:
        def fit_peak(dmat, **knobs):
            """(booster, seconds, launches, peak device bytes above the
            allocation before the fit)."""
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ops.reset_launches()
            t0 = time.perf_counter()
            b = Booster(**booster_kw, **knobs).fit(dmat)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            return b, secs, ops.launches(), torch.cuda.max_memory_allocated() - base

        for chunk_rows in (ext_chunk, EXT_ODD_CHUNK_ROWS):
            dres = ExternalDMatrix.from_arrays(x_tr, y_tr, chunk_rows=chunk_rows, ref=dtrain,
                                               paging="resident")
            dst = ExternalDMatrix.from_arrays(x_tr, y_tr, chunk_rows=chunk_rows, ref=dtrain,
                                              paging="stream")
            dres.unload()
            rbst, res_s, _, res_peak = fit_peak(dres)
            racc = accuracy(rbst.predict(x_te))
            dres.unload()
            stack_bytes = dst.nbytes_host
            chunk_bytes = stack_bytes // dst.n_chunks
            for prefetch in (2, 0):
                dst.prefetch_chunks = prefetch
                sbst, st_s, got, st_peak = fit_peak(dst)
                st = dst.stream_stats
                after_fit = dst.nbytes_device
                sacc = accuracy(sbst.predict(x_te))
                predict_exact = bool(torch.equal(sbst.predict_margins(dst),
                                                 sbst.predict_margins(dtrain)))
                want_saving = (stack_bytes - (prefetch + 1) * chunk_bytes) / 2
                line = {"phase": "stream", "chunk_rows": chunk_rows, "n_chunks": dst.n_chunks,
                        "prefetch_chunks": prefetch, "stack_bytes": stack_bytes,
                        "chunk_bytes": chunk_bytes, "first_fit_s": st_s,
                        "resident_first_fit_s": res_s, "launches": got,
                        "row_segments": st.row_segments, "chunks_paged": st.chunks_paged,
                        "rows_touched": st.rows_touched, "device_slots": st.device_slots,
                        "nbytes_device_after_fit": after_fit,
                        "nbytes_device_after_predict": dst.nbytes_device,
                        "fit_peak_above_before": st_peak,
                        "resident_fit_peak_above_before": res_peak,
                        "peak_saving_wanted": want_saving, "held_out_accuracy": sacc,
                        "resident_accuracy": racc, "predict_equals_flat": predict_exact,
                        "trees_same_structure_as_resident": same_structure(sbst.ensemble,
                                                                           rbst.ensemble),
                        "bit_for_bit_resident": same_model(sbst, rbst)}
                emit(line)
                expect_launches(f"streamed fit at {chunk_rows} rows a chunk, prefetch {prefetch}",
                                got, {"histogram_private": ROUNDS * dst.n_chunks,
                                      "histogram_rows": st.row_segments,
                                      "split_scan": ROUNDS * DEPTH})
                if not (st.row_segments <= (ROUNDS * (DEPTH - 1)) * dst.n_chunks
                        and abs(sacc - racc) <= 0.003 and sacc > 0.7 and after_fit == 0
                        and dst.nbytes_device == 0
                        and st.device_slots == min(prefetch + 1, dst.n_chunks)
                        and res_peak - st_peak >= want_saving and predict_exact
                        and line["bit_for_bit_resident"]):
                    raise SystemExit(f"stream phase failed: {line}")
            del rbst, sbst
            if chunk_rows == ext_chunk:
                dres_main, dst_main = dres, dst
            else:
                del dres, dst
        # Readings on the reference chunk size: warm alternating pairs of the
        # streamed and the resident fit (its stack left on the card between its
        # fits, as a resident fit keeps it), of prefetch 2 and 0; the pinned
        # copy rate of one chunk and the transfer floor it sets; syncs; GOSS.
        dst, dres = dst_main, dres_main
        dst.prefetch_chunks = 2
        pairs: dict[str, list[float]] = {"stream": [], "resident": [], "prefetch_2": [],
                                         "prefetch_0": []}
        for i in range(STREAM_PAIRS):
            for name in ("stream", "resident") if i % 2 == 0 else ("resident", "stream"):
                pairs[name].append(host_s(lambda: Booster(**booster_kw).fit(
                    dst if name == "stream" else dres)))
            for p in (2, 0) if i % 2 == 0 else (0, 2):
                dst.prefetch_chunks = p
                pairs[f"prefetch_{p}"].append(host_s(lambda: Booster(**booster_kw).fit(dst)))
        dst.prefetch_chunks = 2
        dres.unload()
        med = {k: sorted(v)[STREAM_PAIRS // 2] for k, v in pairs.items()}
        pinned = torch.from_numpy(dst._host_packed[0].view(np.int32)).pin_memory()
        slot = torch.empty(pinned.shape, dtype=torch.int32, device=dev)
        for _ in range(5):
            slot.copy_(pinned, non_blocking=True)
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        for _ in range(50):  # back to back, as a pass's copies run
            slot.copy_(pinned, non_blocking=True)
        ev1.record()
        torch.cuda.synchronize()
        copy_ms = ev0.elapsed_time(ev1) / 50
        rate = pinned.numel() * 4 / (copy_ms / 1e3)
        Booster(**booster_kw).fit(dst)
        full = dst.stream_stats
        floor_s = full.chunks_paged * pinned.numel() * 4 / rate
        syncs_stream = count_syncs(lambda: Booster(**booster_kw).fit(dst))
        syncs_resident = count_syncs(lambda: Booster(**booster_kw).fit(dres))
        dres.unload()
        goss_knobs = STOCH_FITS["goss"][0]
        gbst = Booster(**booster_kw, **goss_knobs).fit(dst)
        goss = dst.stream_stats
        read_line = {"phase": "stream", "chunk_rows": dst.chunk_rows, "pairs": STREAM_PAIRS,
                     "fit_s": pairs, "median_stream_s": med["stream"],
                     "median_resident_s": med["resident"],
                     "stream_over_resident": med["stream"] / med["resident"],
                     "median_prefetch_2_s": med["prefetch_2"],
                     "median_prefetch_0_s": med["prefetch_0"],
                     "prefetch_0_over_2": med["prefetch_0"] / med["prefetch_2"],
                     "pinned_chunk_copy_ms": copy_ms, "pinned_copy_bytes_per_s": rate,
                     "chunks_paged": full.chunks_paged, "rows_touched": full.rows_touched,
                     "transfer_floor_s": floor_s,
                     "stream_over_floor": med["stream"] / floor_s,
                     "syncs_stream": syncs_stream, "syncs_resident": syncs_resident,
                     "goss": {"chunks_paged": goss.chunks_paged, "rows_touched": goss.rows_touched,
                              "held_out_accuracy": accuracy(gbst.predict(x_te))},
                     "nvidia_smi": nvidia_smi()}
        emit(read_line)
        # Page-in faults through a streamed fit, on a fresh matrix of the first
        # rows: chunk_load once (one retry warning, the fit completes) and
        # chunk_corrupt always (ChunkIntegrityError naming the chunk).
        stream_faults = {}
        for name_f, site, arm in (
                ("load_once", "chunk_load", dict(error=faults.TransientLoadError, times=1)),
                ("corrupt_always", "chunk_corrupt", dict(times=None, index=9, bit=7))):
            fresh = ExternalDMatrix.from_arrays(x_tr[:fault_rows], y_tr[:fault_rows],
                                                chunk_rows=-(-fault_rows // FAULT_CHUNKS),
                                                ref=dtrain, load_backoff=0.0, paging="stream")
            with warnings.catch_warnings(record=True) as seen, faults.inject(site, **arm) as spec:
                warnings.simplefilter("always")
                try:
                    fb = Booster(**booster_kw).fit(fresh)
                    err, done = None, fb.n_rounds_trained
                except ChunkIntegrityError as exc:
                    err, done = str(exc), None
            stream_faults[name_f] = {"fired": spec.fired,
                                     "warnings": [str(w.message) for w in seen],
                                     "error": err, "rounds": done}
        emit({"phase": "stream", "faults": stream_faults})
        lo, co = stream_faults["load_once"], stream_faults["corrupt_always"]
        if not (lo["fired"] == 1 and len(lo["warnings"]) == 1 and "retry 1/" in lo["warnings"][0]
                and lo["rounds"] == ROUNDS and co["error"] is not None
                and "ExternalDMatrix chunk 0" in co["error"]):
            raise SystemExit(f"stream page-in faults: {stream_faults}")

    stream_phase()

    # --- 15. resilience: numeric sentinel, kill and resume, faults ------------
    # nan_grad armed at round NAN_ROUND of the 10-round default fit, under
    # each policy; a raise fit without a fault reads its flags once a chunk.
    policy = {}
    for pol in ("raise", "warn_skip", "clamp"):
        with faults.inject("nan_grad", round=NAN_ROUND), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                pbst = Booster(**booster_kw, numeric_check=pol).fit(dtrain)
                policy[pol] = {"skipped_rounds": pbst.skipped_rounds,
                               "events": pbst.resilience_events,
                               "margins_finite": bool(torch.isfinite(pbst.margins).all()),
                               "skipped_leaves_zero": bool(
                                   (pbst.ensemble.leaf_value[NAN_ROUND] == 0).all()),
                               "held_out_accuracy": accuracy(pbst.predict(x_te))}
            except NumericError as exc:
                policy[pol] = {"error": str(exc)}
    syncs_raise = count_syncs(lambda: Booster(**booster_kw, numeric_check="raise").fit(dtrain))
    syncs_default = count_syncs(lambda: Booster(**booster_kw).fit(dtrain))
    res_line = {"phase": "resilience", "nan_round": NAN_ROUND, "policies": policy,
                "syncs_raise_no_fault": syncs_raise, "syncs_default": syncs_default}
    emit(res_line)
    if not (f"round(s) [{NAN_ROUND}," in policy["raise"].get("error", "")
            and policy["warn_skip"].get("skipped_rounds") == [NAN_ROUND]
            and policy["warn_skip"]["skipped_leaves_zero"]
            and policy["warn_skip"]["margins_finite"]
            and policy["clamp"].get("events") == [{"event": "gradients_clamped",
                                                   "rounds": [NAN_ROUND]}]
            and policy["clamp"]["margins_finite"]
            and syncs_raise <= syncs_default + 1):  # one chunk: one read
        raise SystemExit(f"numeric policies failed: {res_line}")

    # Kill and resume: a child process a variant fits 10 rounds with
    # checkpoint_every=RESUME_EVERY on the same rows (saved here, so its
    # matrix is this one) and SIGKILLs itself once round RESUME_KILL is read;
    # the children run at once. Each snapshot resumes here.
    rows_file = work / "resume_rows.npz"
    np.savez(rows_file, x_tr=x_tr, y_tr=y_tr, x_te=x_te, y_te=y_te)
    children = {}
    for name_v, (knobs, es) in RESUME_VARIANTS.items():
        ckpt = work / f"resume_{name_v}.ckpt"
        ckpt.unlink(missing_ok=True)
        child = RESUME_CHILD.format(src=str(ROOT / "src"), rows=str(rows_file),
                                    kw={**booster_kw, **knobs}, es=es, every=RESUME_EVERY,
                                    path=str(ckpt), kill=RESUME_KILL)
        children[name_v] = (ckpt, subprocess.Popen([sys.executable, "-c", child],
                                                    stdout=subprocess.PIPE,
                                                    stderr=subprocess.PIPE, text=True))
    resumed = {}
    for name_v, (ckpt, proc) in children.items():
        try:
            out, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
        if proc.returncode != -SIGKILL or "FIT-COMPLETED" in out:
            raise SystemExit(f"resume child {name_v} exited {proc.returncode}:\n{err[-2000:]}")
        knobs, es = RESUME_VARIANTS[name_v]
        snap, rs = load_booster_with_resume(str(ckpt))
        evals_v = [(dte, "valid")] if es else []
        t0 = time.perf_counter()
        got = Booster.resume(str(ckpt), dtrain, evals=evals_v)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        whole = Booster(**booster_kw, **knobs).fit(
            dtrain, evals=evals_v, early_stopping_rounds=es,
            eval_metric="logloss" if es else None)
        k0 = int(rs["rounds_done"])
        snap_exact = all(torch.equal(getattr(got.ensemble, f_)[:k0], getattr(snap.ensemble, f_))
                         for f_ in ENSEMBLE_FIELDS)
        # The snapshot's margins entered the loop as carried: from them, the
        # resumed trees' leaves replayed in the loop's order give the
        # resumed fit's final margins bit for bit.
        replay = rs["margins"]
        for t in range(k0, got.ensemble.n_trees):
            e_ = got.ensemble
            replay = replay + torch.stack([traverse_tree_packed(
                e_.feature[t], e_.split_bin[t], e_.default_left[t], e_.leaf_value[t],
                e_.is_leaf[t], dtrain.matrix.packed, dtrain.bits, args.rows, MAX_BINS - 1,
                DEPTH)], dim=1)
        margins_exact = got.margins is not None and bool(torch.equal(replay, got.margins))
        racc, wacc = accuracy(got.predict(x_te)), accuracy(whole.predict(x_te))
        resumed[name_v] = {"snapshot_rounds": k0, "n_rounds_trained": got.n_rounds_trained,
                           "snapshot_trees_exact": snap_exact,
                           "snapshot_margins_entered_exact": margins_exact,
                           "held_out_accuracy": racc, "uninterrupted_accuracy": wacc,
                           "trees_same_structure_as_uninterrupted": same_structure(
                               got.ensemble, whole.ensemble),
                           "bit_for_bit_uninterrupted": (
                               same_model(got, whole) and same_margins(got, whole)),
                           "resume_s": resume_s}
        if not (got.n_rounds_trained == ROUNDS and snap_exact and margins_exact
                and abs(racc - wacc) <= 0.003 and k0 == RESUME_EVERY
                and resumed[name_v]["bit_for_bit_uninterrupted"]):
            raise SystemExit(f"resume {name_v} failed: {resumed[name_v]}")
    emit({"phase": "resilience", "resume": resumed})
    rows_file.unlink()

    # checkpoint_write: armed once, the snapshot's retry succeeds; armed
    # always, the fit completes with a warning and the failed writes'
    # events, and the file written before the fault is unchanged.
    ck_path = work / "write_fault.ckpt"
    with faults.inject("checkpoint_write", error=OSError, times=1) as spec:
        once = Booster(**booster_kw).fit(dtrain, checkpoint_every=5, checkpoint_path=str(ck_path))
    once_ok = spec.fired == 1 and once.resilience_events == [] and \
        Booster.load(str(ck_path)).n_rounds_trained == ROUNDS
    bst.save(str(ck_path))
    before = ck_path.read_bytes()
    with faults.inject("checkpoint_write", error=OSError, times=None), \
            warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        always = Booster(**booster_kw).fit(dtrain, checkpoint_every=5,
                                           checkpoint_path=str(ck_path))
    ckw = {"once_retried": once_ok,
           "always_events": [e["event"] for e in always.resilience_events],
           "always_warnings": sum("checkpoint write" in str(w.message) for w in seen),
           "always_completed": always.n_rounds_trained == ROUNDS,
           "file_unchanged": ck_path.read_bytes() == before}
    # oom armed once with on_oom="external": one fallback at n_rows // 2, the
    # fit through the chunk stack on the card; without on_oom it raises.
    ops.reset_launches()
    with faults.inject("oom", error=faults.SimulatedOOM), \
            warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        obst = Booster(**booster_kw).fit(dtrain, on_oom="external")
    oom_launches = ops.launches()
    with faults.inject("oom", error=faults.SimulatedOOM):
        try:
            Booster(**booster_kw).fit(dtrain)
            plain_raises = False
        except faults.SimulatedOOM:
            plain_raises = True
    oom = {"events": obst.resilience_events, "warnings": len(seen),
           "held_out_accuracy": accuracy(obst.predict(x_te)), "launches": oom_launches,
           "without_on_oom_raises": plain_raises}
    emit({"phase": "resilience", "checkpoint_write": ckw, "oom": oom})
    expect_launches("on_oom='external' fit", oom_launches, path_launches())
    if not (once_ok and ckw["always_events"] == ["checkpoint_write_failed"] * 2
            and ckw["always_warnings"] == 2 and ckw["always_completed"]
            and ckw["file_unchanged"] and plain_raises
            and [e["event"] for e in oom["events"]] == ["oom_fallback"]
            and oom["events"][0]["chunk_rows"] == args.rows // 2
            and oom["held_out_accuracy"] > 0.7):
        raise SystemExit(f"resilience faults failed: {ckw} {oom}")
    del obst, always, once, dte

    # --- 16. multi-device training: 2 and 4 shards on cuda:0 ----------------------
    # The main matrix (its rows cut to a multiple of 4) sharded over meshes
    # whose positions all sit on this card, one thread a shard.
    n_dist = args.rows - args.rows % 4
    d_dist = dtrain if n_dist == args.rows else DeviceDMatrix(
        x_tr[:n_dist], label=y_tr[:n_dist], ref=dtrain)
    meshes = {s_: D.make_mesh((s_,), ("data",), device=dev) for s_ in DIST_SHARDS}
    acc_kernel = fitted["kernel"][1]
    dist_fits, dist_bad = {}, []

    def dist_fit(name, s_, knobs=None, data=None, **fit_kw):
        """A sharded fit with its own counts: (booster, line)."""
        fit_kw.setdefault("mesh", meshes[s_])
        ops.reset_launches()
        t0 = time.perf_counter()
        b_ = Booster(**booster_kw, **(knobs or {})).fit(d_dist if data is None else data, **fit_kw)
        torch.cuda.synchronize()
        line_ = {"fit": name, "shards": s_, **(knobs or {}), "fit_s": time.perf_counter() - t0,
                 "launches": ops.launches(), "held_out_accuracy": accuracy(b_.predict(x_te)),
                 "comm_stats": b_.comm_stats}
        dist_fits[name] = (b_, line_)
        return b_, line_

    def want_dist(s_, decompress=0, private=None):
        return {"histogram_private": ROUNDS * DEPTH * s_ if private is None else private,
                "histogram_rows": 0, "split_scan": ROUNDS * DEPTH * s_, "decompress": decompress}

    def tree_fields(t):
        return (t.feature, t.split_bin, t.default_left, t.is_leaf, t.leaf_value, t.gain)

    for s_ in DIST_SHARDS:
        # The first fit at a shard count repacks the words a shard: one
        # decompress (the matrix's unpack()), cached for the next fits.
        b_, line_ = dist_fit(f"psum_{s_}", s_)
        expect_launches(f"dist psum fit at {s_} shards", line_["launches"],
                        want_dist(s_, decompress=1))
        # Replication: every shard grows the same trees, every round.
        runner = D.make_chunk_runner(b_.cfg, b_.obj, d_dist, meshes[s_])
        margins = torch.full((n_dist, 1), b_.base_score, device=dev)
        same = True
        for r in range(ROUNDS):
            out = runner.round_fn(runner.inputs(r, margins))
            same &= all(torch.equal(a_, c_) for o in out[1:] for t0_, tp in zip(out[0][0], o[0])
                        for a_, c_ in zip(tree_fields(t0_), tree_fields(tp)))
            margins = torch.cat([o[1] for o in out])
        # predict of the sharded model: the traversal kernel, bit for bit the
        # plain traversal.
        ens_ = b_.ensemble
        plain = ref.ensemble_margins_ref(ens_.feature, ens_.threshold, ens_.default_left,
                                         ens_.leaf_value, ens_.is_leaf, xte_dev, ens_.n_classes,
                                         DEPTH) + ens_.base_score
        line_.update(replicated=same, predict_exact=bool(torch.equal(
            b_.predict_margins(xte_dev), plain)))
        if not (same and line_["predict_exact"] and line_["held_out_accuracy"] > 0.7
                and abs(line_["held_out_accuracy"] - acc_kernel) <= 0.003):
            dist_bad.append(line_)
        emit({"phase": "dist", **line_, "accuracy_kernel_path": acc_kernel})

    # The collective alone on the card: the 4 shards' root histograms of the
    # main matrix, every strategy, against the CPU's. The (g, h) are those
    # after the main fit's 10 rounds: full float32 mantissas, so f16 and q16
    # encode them with an error.
    s4 = max(DIST_SHARDS)
    runner = D.make_chunk_runner(bst.cfg, bst.obj, d_dist, meshes[s4])
    per = runner.n_per
    gh0 = bst.obj.grad(bst.margins[:n_dist], d_dist.label)[:, 0, :].contiguous()
    zeros = torch.zeros(per, dtype=torch.int32, device=dev)
    roots = [build_histograms_packed_kernel(runner.bins[p].packed, gh0[p * per:(p + 1) * per],
                                            zeros, 1, MAX_BINS, dtrain.bits) for p in range(s4)]
    mesh22 = D.make_mesh((2, 2), ("data", "pod"), device=dev)
    cpu_meshes = {"4": D.make_mesh((s4,), ("data",), device="cpu"),
                  "2x2": D.make_mesh((2, 2), ("data", "pod"), device="cpu")}

    def reduce_all(mesh_, axes_, name_, comp_, tol_, xs):
        c_ = D.get_collective(name_, mesh_, axes_, compression=comp_, tolerance=tol_)

        def body(x_):
            c_.begin_round()
            return c_.allreduce_hist(x_), c_.fallback_count()

        out_ = D.spmd(mesh_, body, [x_.to(mesh_.device(p_)) for p_, x_ in enumerate(xs)])
        return [o[0] for o in out_], [int(o[1]) for o in out_]

    card_q = {nm: reduce_all(meshes[s4], ("data",), nm, "q16", 0.05, roots)[0]
              for nm in ("psum", "ring", "hier")}
    card_q["hier_2x2"] = reduce_all(mesh22, ("data", "pod"), "hier", "q16", 0.05, roots)[0]
    cpu_q = reduce_all(cpu_meshes["4"], ("data",), "psum", "q16", 0.05, [r_.cpu() for r_ in roots])[0]
    q_same = all(torch.equal(t_.cpu(), cpu_q[0]) for v in card_q.values() for t_ in v)
    ring32, fb32 = reduce_all(meshes[s4], ("data",), "ring", None, 0.05, roots)
    ring32_cpu = reduce_all(cpu_meshes["4"], ("data",), "ring", None, 0.05,
                            [r_.cpu() for r_ in roots])[0]
    f32_same = all(torch.equal(a_.cpu(), c_) for a_, c_ in zip(ring32, ring32_cpu))
    exact = torch.stack(roots).double().sum(dim=0)
    m_sum = float(sum(float(r_.abs().max()) for r_ in roots))
    ring16, fb16 = reduce_all(meshes[s4], ("data",), "ring", "f16", 0.05, roots)
    f16_err = max(float((t_.double() - exact).abs().max()) for t_ in ring16)
    f16_bound = 2 * s4 * 2.0**-11 * m_sum  # each cast of a partial: half an f16 ulp of <= m_sum
    tight, fb_tight = reduce_all(meshes[s4], ("data",), "ring", "f16", 0.0, roots)
    tight_q, fb_tight_q = reduce_all(meshes[s4], ("data",), "ring", "q16", 0.0, roots)
    tight_exact = all(torch.equal(a_, c_) and torch.equal(b_, c_)
                      for a_, b_, c_ in zip(tight, tight_q, ring32))
    # ms a level of each strategy and compression at level 5's histogram
    # (32 nodes), every shard's reduce, host-timed through the threads.
    lvl5 = [torch.randn((32, dtrain.n_features, MAX_BINS, 2), device=dev) for _ in range(s4)]
    level_ms = {}
    for nm, mesh_, axes_ in (("psum", meshes[s4], ("data",)), ("ring", meshes[s4], ("data",)),
                             ("hier", meshes[s4], ("data",)), ("hier_2x2", mesh22, ("data", "pod"))):
        for comp_ in (None, "f16", "q16"):
            reduce_all(mesh_, axes_, nm.split("_")[0], comp_, 0.05, lvl5)
            level_ms[f"{nm}_{comp_ or 'f32'}"] = host_s(lambda: [reduce_all(
                mesh_, axes_, nm.split("_")[0], comp_, 0.05, lvl5) for _ in range(5)]) / 5 * 1e3
    coll_line = {"phase": "dist", "collective_alone": {
        "shards": s4, "q16_all_equal_and_cpu": q_same, "f32_ring_equals_cpu": f32_same,
        "f32_fallbacks": fb32, "f16_max_err": f16_err, "f16_bound": f16_bound,
        "f16_fallbacks": fb16, "tolerance0_exact": tight_exact,
        "tolerance0_tally": {"f16": fb_tight, "q16": fb_tight_q},
        "level5_ms": level_ms}}
    emit(coll_line)
    if not (q_same and f32_same and f16_err <= f16_bound and tight_exact
            and fb_tight == fb_tight_q == [1] * s4 and fb32 == [0] * s4 and fb16 == [0] * s4):
        dist_bad.append(coll_line)

    # Strategy fits at 4 shards: accuracy within 0.003 of the f32 psum fit,
    # comm_stats the CPU's analytic dict, no fallback at the default tolerance.
    acc_psum = dist_fits[f"psum_{s4}"][1]["held_out_accuracy"]
    for name, mesh_, axes_, coll_, comp_ in (
            ("ring", meshes[s4], ("data",), "ring", None),
            ("hier", meshes[s4], ("data",), "hier", None),
            ("hier_2x2", mesh22, ("data", "pod"), "hier", None),
            ("f16", meshes[s4], ("data",), "ring", "f16"),
            ("q16", meshes[s4], ("data",), "ring", "q16")):
        b_, line_ = dist_fit(name, s4, mesh=mesh_, data_axes=axes_, collective=coll_,
                             compression=comp_)
        cpu_mesh = cpu_meshes["2x2" if mesh_ is mesh22 else "4"]
        want_cs = D.round_comm_stats(
            D.get_collective(coll_, cpu_mesh, axes_, compression=comp_), max_depth=DEPTH,
            n_features=dtrain.n_features, max_bins=MAX_BINS).as_dict()
        line_["comm_stats_equal_cpu"] = b_.comm_stats == want_cs
        emit({"phase": "dist", **line_})
        expect_launches(f"dist {name} fit", line_["launches"], want_dist(s4))
        if not (line_["comm_stats_equal_cpu"] and b_.comm_stats["fallback_events"] == 0
                and abs(line_["held_out_accuracy"] - acc_psum) <= 0.003):
            dist_bad.append(line_)

    # Sampled fits at 2 shards: each shard's masked gh, gathered, bit for bit
    # the one-card masked selection of the same path; accuracy > 0.7.
    s2 = min(DIST_SHARDS)
    per2 = n_dist // s2
    for name, knobs in (("subsample", {"subsample": 0.5}),
                        ("goss", {"sampling_method": "goss", "top_rate": 0.2, "other_rate": 0.1})):
        params = SMP.stochastic_params(Booster(**booster_kw, **knobs).cfg)
        path = (0, 0, 0)  # seed 0, round 0, class 0
        one = SMP.make_tree_context(params, path, gh0, dtrain.n_features, compact=False)[1]
        shards = D.spmd(meshes[s2], lambda p_: SMP.make_tree_context(
            params, path, gh0[p_ * per2:(p_ + 1) * per2], dtrain.n_features, compact=False,
            n_total=n_dist, row_offset=p_ * per2, axis_name=("data",))[1], list(range(s2)))
        b_, line_ = dist_fit(name, s2, knobs)
        line_["selections_equal_one_card"] = bool(torch.equal(torch.cat(shards), one))
        emit({"phase": "dist", **line_})
        expect_launches(f"dist {name} fit", line_["launches"], want_dist(s2))
        if not (line_["selections_equal_one_card"] and line_["held_out_accuracy"] > 0.7):
            dist_bad.append(line_)

    # A resident chunk stack split in whole chunks (8 chunks, 4 a shard),
    # the chunked instantiation of #1; the dense bins (one unpack()).
    acc2 = dist_fits[f"psum_{s2}"][1]["held_out_accuracy"]
    chunk = n_dist // 8
    ext = ExternalDMatrix.from_arrays(x_tr[:n_dist], y_tr[:n_dist], chunk_rows=chunk,
                                      ref=dtrain, paging="resident")
    ext.packed_bins()  # paged in before the counts
    for name, knobs, data, want in (
            ("chunked", None, ext, want_dist(s2)),
            ("dense", {"compress_matrix": False}, None, want_dist(s2, decompress=1, private=0))):
        b_, line_ = dist_fit(name, s2, knobs, data)
        if name == "chunked":
            line_.update(chunk_rows=chunk, n_chunks=ext.n_chunks)
        emit({"phase": "dist", **line_})
        expect_launches(f"dist {name} fit", line_["launches"], want)
        if not (line_["held_out_accuracy"] > 0.7
                and abs(line_["held_out_accuracy"] - acc2) <= 0.003):
            dist_bad.append(line_)
    del ext

    # The sharded sketch: each shard's columns sorted on its position, merged
    # on the host; every finite cut of a feature without collapsed cuts within
    # the reference's rank bound 2 (S + 3) / capacity of its target.
    xs_dev = torch.as_tensor(x_tr[:n_dist], device=dev)
    finite = torch.isfinite(xs_dev)
    cols = torch.sort(torch.where(finite, xs_dev, float("inf")), dim=0).values.t().contiguous()
    n_valid = finite.sum(dim=0)
    nvb = MAX_BINS - 1
    sketch = {}
    for s_ in DIST_SHARDS:
        t0 = time.perf_counter()
        cuts_s = D.sharded_sketch_cuts(x_tr[:n_dist], max_bins=MAX_BINS, mesh=meshes[s_])
        sk_s = time.perf_counter() - t0
        full = torch.isfinite(cuts_s).all(dim=1)
        ranks = torch.searchsorted(cols, cuts_s.contiguous()).double()
        target = (torch.arange(1, nvb, device=dev, dtype=torch.float64)[None, :] / nvb
                  * (n_valid[:, None].double() - 1))
        err = ((ranks - target).abs() / n_valid[:, None].double())[full]
        eps = 2.0 * (s_ + 3) / DIST_SKETCH_CAPACITY
        sketch[s_] = {"seconds": sk_s, "features_checked": int(full.sum()),
                      "max_rank_error": float(err.max()) if err.numel() else None, "bound": eps}
        if not (int(full.sum()) > 0 and float(err.max()) <= eps):
            dist_bad.append({"sketch": s_, **sketch[s_]})
    del xs_dev, finite, cols

    # A shard that raises ends the fit with its exception, in time.
    def failing_obj(m_, y_):
        sh_ = D.group.current()
        if sh_ is not None and sh_.position == 1:
            raise ArithmeticError("shard 1 failed")
        return torch.sigmoid(m_[:, 0]) - y_, torch.ones_like(y_)

    threads_before = threading.active_count()
    t0 = time.perf_counter()
    try:
        Booster(**booster_kw).fit(d_dist, obj=failing_obj, mesh=meshes[s2])
        failure = "no error"
    except ArithmeticError as exc:
        failure = str(exc)
    failure_s = time.perf_counter() - t0
    # Readings: warm fits at 1, 2 and 4 shards in 3 rotations.
    warm: dict[str, list[float]] = {str(s_): [] for s_ in (1, *DIST_SHARDS)}
    for i in range(DIST_PAIRS):
        order = (1, *DIST_SHARDS)[i % 3:] + (1, *DIST_SHARDS)[:i % 3]
        for s_ in order:
            kw_ = {} if s_ == 1 else {"mesh": meshes[s_]}
            warm[str(s_)].append(host_s(lambda: Booster(**booster_kw).fit(d_dist, **kw_)))
    emit({"phase": "dist", "sketch": sketch, "failure": failure, "failure_s": failure_s,
          "threads_left": threading.active_count() - threads_before,
          "warm_fit_s": warm, "warm_fit_s_median": {k: float(np.median(v)) for k, v in warm.items()},
          "comm_bytes_per_round": {k: v[1]["comm_stats"]["bytes_per_round"]
                                   for k, v in dist_fits.items()},
          "nvidia_smi": nvidia_smi()})
    if failure != "shard 1 failed" or failure_s > DIST_FAIL_S \
            or threading.active_count() != threads_before:
        dist_bad.append({"failure": failure, "seconds": failure_s})
    if dist_bad:
        raise SystemExit(f"dist phase failed: {dist_bad}")
    del dist_fits, runner, roots, lvl5

    # --- 16b. repeat: every path fitted twice, bit for bit ----------------------
    def repeat_phase() -> None:
        chunked = ExternalDMatrix.from_arrays(x_tr, y_tr, chunk_rows=ext_chunk, ref=dtrain)
        streamed = ExternalDMatrix.from_arrays(x_tr, y_tr, chunk_rows=ext_chunk, ref=dtrain,
                                               paging="stream", prefetch_chunks=2)
        # name: (Booster knobs, training matrix, fit keywords, held-out rows)
        paths = {
            "default": ({}, dtrain, {}, x_te),
            "kernel": (FITS["kernel"], dtrain, {}, x_te),
            "lossguide": (FITS["lossguide"], dtrain, {}, x_te),
            "dense": ({"compress_matrix": False}, dtrain, {}, x_te),
            "dense_kernel": ({"compress_matrix": False, **FITS["kernel"]}, dtrain, {}, x_te),
            "subsample": (STOCH_FITS["subsample"][0], dtrain, {}, x_te),
            "goss": (STOCH_FITS["goss"][0], dtrain, {}, x_te),
            "colsample_bynode": (STOCH_FITS["colsample"][0], dtrain, {}, x_te),
            "monotone": (STOCH_FITS["monotone"][0], dtrain, {}, x_te),
            "rank": ({"objective": "rank:pairwise"}, d_rank, {}, xrv),
            "chunked": ({}, chunked, {}, x_te),
            "streamed": ({}, streamed, {}, x_te),
            "psum_2": ({}, d_dist, {"mesh": meshes[min(DIST_SHARDS)]}, x_te),
        }
        rep = {}
        for name_r, (knobs, dmat, fit_kw, rows_) in paths.items():
            times_r, models = [], []
            for _ in range(2):
                t0 = time.perf_counter()
                models.append(Booster(**{**booster_kw, **knobs}).fit(dmat, **fit_kw))
                torch.cuda.synchronize()
                times_r.append(time.perf_counter() - t0)
            rep[name_r] = {"bit_for_bit": same_model(*models, x_=rows_)
                           and same_margins(*models), "fit_s": times_r}
        emit({"phase": "repeat", "rounds": ROUNDS, "chunk_rows": ext_chunk, "paths": rep})
        bad = [k for k, v in rep.items() if not v["bit_for_bit"]]
        if bad:
            raise SystemExit(f"repeat phase: fitted twice, these paths differ: {bad}")

    repeat_phase()

    if args.profile:
        profile_fit(dtrain)
        profile_fit(dtrain, "dense", {"compress_matrix": False})
        profile_fit(dtrain, "evals", {"n_rounds": EVAL_ROUNDS}, eval_kw)
        profile_fit(dtrain, "no_evals", {"n_rounds": EVAL_ROUNDS})
        profile_fit(dtrain, "subsample", STOCH_FITS["subsample"][0])
        profile_fit(ExternalDMatrix.from_arrays(x_tr, y_tr, chunk_rows=ext_chunk, ref=dtrain,
                                                paging="stream"), "stream")
        profile_fit(d_dist, "dist", fit_kw={"mesh": meshes[min(DIST_SHARDS)]})

    # --- 17. feature-sharded growth: (2, 2) and (1, 4) meshes on cuda:0 --------
    def feature_phase() -> None:
        from repro_torch.core import tree as TT
        from repro_torch.core.predict import fold_classes, predict_raw, stack_trees
        from repro_torch.launch import dryrun_gbdt

        cfg = Booster(**booster_kw).cfg
        obj = O.get_objective("binary:logistic")
        n = dtrain.n_rows
        ops.reset_launches()
        dense = dtrain.matrix.unpack()  # one decompress
        unpack_launches = ops.launches()["decompress"]
        cuts, packed_bins = dtrain.cuts, dtrain.packed_bins()
        base = float(obj.init_base_score(dtrain.label))
        d_te = DeviceDMatrix(x_te, ref=dtrain)
        fields = ("feature", "split_bin", "default_left", "leaf_value", "is_leaf")
        bad = []

        def grow_all(mesh, builder, gh, ctx=None):
            """Every position's tree of one round (mesh None: one position,
            feature_axis=None)."""
            if mesh is None:
                return [TT.grow_tree(dense, gh, cuts, DEPTH, MAX_BINS, cfg.split_params,
                                     hist_builder=builder, ctx=ctx)]
            coll = D.PsumCollective(mesh, ("data",))
            parts = D.shard_features(dense, cuts, mesh, ("data",), "model")
            n_rows, shard_of, _ = mesh.shards(("data",))
            per = n // n_rows
            return D.spmd(mesh, lambda part, g: TT.grow_tree(
                part[0], g, part[1], DEPTH, MAX_BINS, cfg.split_params, hist_builder=builder,
                ctx=ctx, collective=coll, feature_axis="model"),
                parts, [gh[s * per:(s + 1) * per] for s in shard_of])

        def boost(mesh, builder):
            """ROUNDS rounds driven here: (trees, launches a tree, replicated
            in every round, seconds a round)."""
            margins = torch.full((n, 1), base, device=dev)
            trees, counts, same, secs = [], [], True, []
            for _ in range(ROUNDS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                gh = obj.grad(margins, dtrain.label)[:, 0, :].contiguous()
                ops.reset_launches()
                out = grow_all(mesh, builder, gh)
                counts.append(ops.launches())
                same &= all(torch.equal(a, b) for t in out[1:] for a, b in zip(out[0], t))
                leaves = packed_bins.traverse(*(getattr(out[0], f_)[None] for f_ in fields),
                                              MAX_BINS - 1, DEPTH)
                margins = margins + cfg.learning_rate * leaves.t()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                trees.append(out[0])
            return trees, counts, same, secs

        def held_out(trees):
            """Accuracy of the model's raw-row predictions, and their largest
            gap to its bin-space margins."""
            ens = stack_trees(trees, 1, base, leaf_scale=cfg.learning_rate)
            raw = predict_raw(ens, xte_dev, DEPTH)
            binned = fold_classes(d_te.packed_bins().traverse(
                *(getattr(ens, f_) for f_ in fields), MAX_BINS - 1, DEPTH), ens) + base
            return accuracy(obj.transform(raw)), float((raw - binned).abs().max())

        round_s = {}
        for name_b, builder in (("default", None), ("kernel", ops.build_histograms_kernel)):
            trees1, _, _, secs1 = boost(None, builder)
            acc1, _ = held_out(trees1)
            round_s[f"1_{name_b}"] = float(np.median(secs1))
            for shape in FEATURE_MESHES:
                mesh = D.make_mesh(shape, ("data", "model"), device=dev)
                s_ = mesh.size
                trees, counts, same, secs = boost(mesh, builder)
                acc_, gap = held_out(trees)
                want = {"split_scan": DEPTH * s_, "histogram_rows": 0,
                        "histogram_private": DEPTH * s_ if builder else 0}
                counts_ok = all(c_[k] == v for c_ in counts for k, v in want.items())
                tag = "x".join(map(str, shape))
                round_s[f"{tag}_{name_b}"] = float(np.median(secs))
                line_ = {"phase": "feature", "mesh": tag, "builder": name_b, "rounds": ROUNDS,
                         "launches_per_tree": counts[0], "launches_expected": want,
                         "launches_every_tree": counts_ok, "replicated_every_round": same,
                         "held_out_accuracy": acc_, "accuracy_unsharded": acc1,
                         "raw_vs_binned_max_err": gap, "round_s": secs,
                         "round_s_unsharded": secs1}
                emit(line_)
                if not (counts_ok and same and acc_ > 0.7 and abs(acc_ - acc1) <= 0.003
                        and gap <= 1e-5):
                    bad.append(line_)

        # The refusals, on the card: packed bins, a sample buffer, and
        # monotone constraints under feature_axis (before any launch).
        gh0 = obj.grad(torch.full((n, 1), base, device=dev), dtrain.label)[:, 0, :].contiguous()
        refusals = {}

        def refused(name_r, fn):
            try:
                fn()
                refusals[name_r] = "no error"
            except NotImplementedError as exc:
                refusals[name_r] = str(exc)

        refused("packed", lambda: TT.grow_tree(packed_bins, gh0, cuts, DEPTH, MAX_BINS,
                                               feature_axis="model"))
        buffer_ctx = SMP.TreeContext(
            key=(args.seed, 0, 0), row_ids=torch.arange(1024, dtype=torch.int32, device=dev),
            feature_mask=None, params=SMP.StochasticParams(subsample=0.5), device=dev)
        refused("buffer", lambda: TT.grow_tree(dense, gh0[:1024], cuts, DEPTH, MAX_BINS,
                                               ctx=buffer_ctx, feature_axis="model"))
        mesh22 = D.make_mesh(FEATURE_MESHES[0], ("data", "model"), device=dev)
        mono_ctx = SMP.TreeContext(
            key=(args.seed, 0, 0), row_ids=None, feature_mask=None, device=dev,
            params=SMP.StochasticParams(monotone=MONOTONE[:dense.shape[1] // 2]))
        ops.reset_launches()
        refused("monotone", lambda: grow_all(mesh22, None, gh0, ctx=mono_ctx))
        mono_launches = sum(ops.launches().values())
        ref_ok = (refusals["packed"] == "feature-sharded growth requires dense bins "
                  "(unpack per shard)"
                  and refusals["buffer"].startswith("sharded growth uses masked-mode")
                  and "tree.py:322" in refusals["monotone"] and mono_launches == 0)

        # The GBDT dry run of both modes: bytes a position posted by kind.
        t0 = time.perf_counter()
        d_bins, d_cuts, d_y = dryrun_gbdt.airline(DRYRUN_ROWS, DRYRUN_FEATURES, MAX_BINS, dev)
        d_mesh = D.make_mesh(DRYRUN_MESH, ("data", "model"), device=dev)
        dry = [dryrun_gbdt.run(mode, d_mesh, d_bins, d_cuts, d_y, MAX_BINS)
               for mode in dryrun_gbdt.MODES]
        line_ = {"phase": "feature", "unpack_decompress_launches": unpack_launches,
                 "refusals": refusals, "monotone_refusal_launches": mono_launches,
                 "round_s_median": round_s, "dryrun": dry,
                 "dryrun_s": time.perf_counter() - t0, "nvidia_smi": nvidia_smi()}
        emit(line_)
        if not (ref_ok and unpack_launches == 1 and all(r["replicated"] for r in dry)):
            bad.append({k: line_[k] for k in ("refusals", "monotone_refusal_launches",
                                              "unpack_decompress_launches")})
        if bad:
            raise SystemExit(f"feature phase failed: {bad}")

    feature_phase()

    # --- 18. the LM substrate at full width -----------------------------------
    train_peak_gib = lm_phase(dev, args.seed)

    # --- 19. the LM's sharded dry run ------------------------------------------
    lm_dryrun_phase(dev, train_peak_gib)

    # Inputs of the kernel phases, at the main path's shapes.
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n, f = dtrain.n_rows, dtrain.n_features
    packed, bits = dtrain.matrix.packed, dtrain.bits
    p = torch.sigmoid(torch.randn(n, device=dev, generator=gen))
    yy = torch.as_tensor(y_tr, device=dev)
    gh = torch.stack([p - yy, p * (1 - p)], dim=1).contiguous()
    # Integer (g, h), g in {-1, 0, 1} and h = 1: every partial sum is an
    # integer below 2^24 in magnitude (there are fewer rows per bin), so it is
    # exact in float32 in any order, and kernel and plain version must agree
    # exactly: h counts the rows of each (node, feature, bin), so every row
    # must land in its own. The skewed words put most rows in one bin.
    gh_exact = torch.stack([
        torch.randint(-1, 2, (n,), device=dev, generator=gen).to(torch.float32),
        torch.ones(n, device=dev),
    ], dim=1).contiguous()
    ones = torch.ones_like(gh)

    def level_positions(n_nodes: int) -> torch.Tensor:
        """Rows spread over the level's nodes; inactive rows carry n_nodes
        or, as the reference pads them for histogram_packed, -1."""
        pos = torch.randint(0, n_nodes + 1, (n,), device=dev, generator=gen,
                            dtype=torch.int32)
        gone = torch.rand(n, device=dev, generator=gen) < 0.05
        return torch.where(gone, -1, pos).to(torch.int32)

    def row_buffer(n_par: int):
        """A compacted buffer as the subtraction trick makes it: n // 2 slots,
        the selected rows (45% of all) in row order, 5% of them at the dump
        position, then padding slots with id n at the dump position."""
        m = n // 2
        rid = torch.nonzero(torch.rand(n, device=dev, generator=gen) < 0.45)[:m, 0]
        k = rid.shape[0]
        rid = torch.cat([rid, torch.full((m - k,), n, device=dev, dtype=rid.dtype)])
        pos = torch.randint(0, n_par, (m,), device=dev, generator=gen, dtype=torch.int32)
        dump = torch.rand(m, device=dev, generator=gen) < 0.05
        pos = torch.where(dump | (torch.arange(m, device=dev) >= k), n_par, pos)
        return rid.to(torch.int32), pos.to(torch.int32)

    levels = {nn: level_positions(nn) for nn in HIST_NODES}
    buffers = {npar: row_buffer(npar) for npar in ROW_PARENTS}
    # The training matrix with SKEW of its symbols moved to the missing bin,
    # as in sparse data: many lanes of a warp add to one (node, bin).
    dense = unpack(packed, bits, n)
    skewed = pack(torch.where(torch.rand(dense.shape, device=dev, generator=gen) < SKEW,
                              MAX_BINS - 1, dense), bits)
    # The training matrix with feature 0 constant in a value bin: every lane
    # of a warp adds to one (node, bin), and none of them is the missing bin.
    constant = packed.clone()
    constant[0] = pack(torch.full((n, 1), CONSTANT_BIN, device=dev, dtype=torch.int32),
                       bits)[0]

    def counts_and_tolerance(plain, *args):
        """Rows per bin, and the tolerance for real-valued (g, h): atomics add
        in no fixed order, and summing k terms in two arbitrary orders
        differs by about sqrt(k) * 2^-24 * sum|x|; four times that, per bin."""
        count = plain(*args[:1], ones[:args[1].shape[0]], *args[2:])[..., :1]
        if float(count.max()) >= 2**24:
            raise SystemExit("rows per bin too many for the exact histogram check")
        mag = plain(*args[:1], args[1].abs(), *args[2:])
        return 2e-5 + 4 * count.sqrt() * 2**-24 * mag

    # --- 19. the ops path of histogram_packed and decompress -----------------
    ops.reset_launches()
    hp = ops.histogram_packed_op(packed, gh, levels[32], 32, MAX_BINS, bits)
    bins = ops.decompress_op(packed, bits, n)
    bins_unpacked = dtrain.matrix.unpack()
    torch.cuda.synchronize()
    ops_launches = ops.launches()
    want_hp = ref.histogram_packed_ref(packed, gh, levels[32], 32, MAX_BINS, bits)
    hp_ok = bool(((hp - want_hp).abs() <= counts_and_tolerance(
        ref.histogram_packed_ref, packed, gh, levels[32], 32, MAX_BINS, bits)).all())
    bins_exact = bool(torch.equal(bins, dense))
    unpack_exact = bool(torch.equal(bins_unpacked, dense))
    emit({"phase": "ops", "launches": ops_launches, "histogram_packed_op_ok": hp_ok,
          "decompress_op_exact": bins_exact, "matrix_unpack_exact": unpack_exact,
          "bins_shape": list(bins.shape)})
    expect_launches("ops path", ops_launches, {"histogram_packed": 1, "decompress": 2})
    if not (hp_ok and bins_exact and unpack_exact) or bins.shape != (n, f):
        raise SystemExit("the ops path's histogram or bins disagree with the plain versions")
    del bins, bins_unpacked

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    def time_ms(fn, iters=20, warmup=3) -> float:
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            flush.zero_()  # each launch finds the L2 cold, as in a fit
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            total += s.elapsed_time(e)
        return total / iters

    def back_to_back_ms(fn, launches=100) -> float:
        """Device ms per launch of `launches` launches queued behind a sleeping
        kernel, so that no host time falls between them: for kernels of a few
        microseconds, whose single-launch event times are mostly the host's.
        Inputs stay in L2, as a level's histogram does in a fit."""
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)  # ~25 ms of device time to queue behind
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(launches):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / launches

    def random_ensemble(n_trees: int, depth: int, n_features: int, g, leaf_share=0.2):
        """Random complete arenas: `leaf_share` of the nodes leaves, the last
        level all leaves, thresholds around the features' scale."""
        a = 2 ** (depth + 1) - 1
        is_leaf = torch.rand(n_trees, a, device=dev, generator=g) < leaf_share
        is_leaf[:, 2 ** depth - 1:] = True
        thr = torch.randn(n_trees, a, device=dev, generator=g)
        thr[is_leaf] = float("inf")
        return (torch.randint(0, n_features, (n_trees, a), device=dev, generator=g,
                              dtype=torch.int32),
                thr, torch.rand(n_trees, a, device=dev, generator=g) < 0.5,
                torch.randn(n_trees, a, device=dev, generator=g), is_leaf)

    # --- 20. kernels against their plain versions ---------------------------
    results: dict[str, dict] = {}
    checked: dict[str, list] = {"histogram_private": [], "histogram_packed": [],
                                "histogram_rows": []}

    def check(got, want, tol):
        err = float((got - want).abs().max())
        ok = bool(((got - want).abs() <= tol).all())
        return err, ok

    def check_histogram(name, kernel, plain, fixed, size, *rest, words=packed, data="higgs",
                        chunk_rows=None):
        """Exact on integer (g, h); within the sqrt(rows) tolerance on real.
        On the skewed and constant words the real-valued plain version runs
        in float64: in float32 its index_add_ adds a hot bin's hundreds of
        thousands of positive h one at a time, and that running sum drifts
        past the tolerance by itself (the kernels add blocked or aggregated
        sums). On both (g, h), `torch.equal` to the fixed-point plain
        version `fixed` (the same integers, whatever the atomics' order) and
        to a second call. With `chunk_rows`, `words` is a chunk stack and
        kernel and plain versions take its chunk_rows."""
        if chunk_rows is not None:
            kernel = functools.partial(_append_arg, kernel, chunk_rows)
            plain = functools.partial(_append_arg, plain, chunk_rows)
            fixed = functools.partial(_append_arg, fixed, chunk_rows)
        inputs = {"exact": (words, gh_exact, *rest), "real": (words, gh, *rest)}
        if name == "histogram_rows":  # (g, h) gathered for each slot's row
            rid = rest[1].to(torch.int64).clamp(max=n - 1)
            inputs = {k: (words, v[1][rid], *rest) for k, v in inputs.items()}
        got_exact = kernel(*inputs["exact"])
        exact_err = float((got_exact - plain(*inputs["exact"])).abs().max())
        got = kernel(*inputs["real"])
        real = inputs["real"]
        want = plain(*real) if data == "higgs" else plain(real[0], real[1].double(), *real[2:])
        err, ok = check(got, want, counts_and_tolerance(plain, *real))
        same_bits = (torch.equal(got_exact, fixed(*inputs["exact"]))
                     and torch.equal(got, fixed(*real)) and torch.equal(kernel(*real), got))
        checked[name].append({"nodes": size, "data": data, "chunk_rows": chunk_rows,
                              "exact_max_abs_err": exact_err, "max_abs_err": err, "ok": ok,
                              "fixed_plain_and_second_call_bit_for_bit": same_bits})
        if exact_err != 0.0 or not ok or not same_bits:
            raise SystemExit(f"{name} disagrees at {size} nodes on {data}: exact "
                             f"{exact_err}, real {err}, fixed point bit for bit {same_bits}")
        return got

    level_hists = {}  # the Higgs-shaped words' real-(g, h) level histograms
    for words, data in ((packed, "higgs"), (skewed, "skewed"), (constant, "constant")):
        for nn in HIST_NODES:
            hist = check_histogram("histogram_private", build_histograms_packed_kernel,
                                   ref.histogram_ref, ref.histogram_fixed_ref, nn, levels[nn],
                                   nn, MAX_BINS, bits, words=words, data=data)
            check_histogram("histogram_packed", histogram_packed, ref.histogram_packed_ref,
                            ref.histogram_packed_fixed_ref, nn, levels[nn], nn, MAX_BINS,
                            bits, words=words, data=data)
            if data == "higgs":
                level_hists[nn] = hist
        for npar in ROW_PARENTS:
            rid, pos = buffers[npar]
            check_histogram("histogram_rows", build_histograms_rows_kernel,
                            ref.histogram_rows_ref, ref.histogram_rows_fixed_ref, npar, pos,
                            rid, npar, MAX_BINS, bits, words=words, data=data)
    # Both kernels' chunked instantiation on the external phase's chunk
    # stacks (padding symbols in every chunk of the 100,003-row stack, a
    # short last chunk in both) and on the skewed words stacked at 100,003
    # rows, against their chunked plain versions, held as the flat shapes.
    skew_stack = to_stack(unpack(skewed, bits, n), EXT_ODD_CHUNK_ROWS, bits)
    for cr, stack_, data in ((ext_chunk, ext_stacks[ext_chunk].packed, "higgs"),
                             (EXT_ODD_CHUNK_ROWS, ext_stacks[EXT_ODD_CHUNK_ROWS].packed, "higgs"),
                             (EXT_ODD_CHUNK_ROWS, skew_stack, "skewed")):
        for nn in HIST_NODES:
            check_histogram("histogram_private", build_histograms_packed_kernel,
                            ref.histogram_chunked_ref, ref.histogram_chunked_fixed_ref, nn,
                            levels[nn], nn, MAX_BINS, bits, words=stack_, data=data,
                            chunk_rows=cr)
        for npar in ROW_PARENTS:
            rid, pos = buffers[npar]
            check_histogram("histogram_rows", build_histograms_rows_kernel,
                            ref.histogram_rows_chunked_ref, ref.histogram_rows_chunked_fixed_ref,
                            npar, pos, rid, npar, MAX_BINS, bits, words=stack_, data=data,
                            chunk_rows=cr)
    del skew_stack
    # #1 at 64 nodes (three node tiles) on both word sets, and both private
    # kernels adding into a running int64 slab that holds earlier sums
    # (`out=`, the streamed pass's form) at 32 and 64 nodes and 16 parents:
    # `torch.equal` to the fixed-point plain version's slab.
    pos64 = level_positions(64)
    for words, data in ((packed, "higgs"), (skewed, "skewed")):
        check_histogram("histogram_private", build_histograms_packed_kernel,
                        ref.histogram_ref, ref.histogram_fixed_ref, 64, pos64, 64, MAX_BINS,
                        bits, words=words, data=data)
    out_equal = {}
    k_gh = FX.exponent(gh)
    for nn, pos in ((32, levels[32]), (64, pos64)):
        slab = torch.randint(-2**40, 2**40, (nn + 1, f, MAX_BINS, 2), device=dev,
                             generator=gen)
        mine = slab[:nn].clone()
        ref.histogram_fixed_ref(packed, gh, pos, nn, MAX_BINS, bits, exponent=k_gh, out=slab)
        build_histograms_packed_kernel(packed, gh, pos, nn, MAX_BINS, bits, out=mine,
                                       exponent=k_gh)
        out_equal[f"histogram_private_{nn}"] = torch.equal(mine, slab[:nn])
    rid16, pos16 = buffers[16]
    gh16 = gh[rid16.to(torch.int64).clamp(max=n - 1)].contiguous()
    k16 = FX.exponent(gh16)
    slab = torch.randint(-2**40, 2**40, (17, f, MAX_BINS, 2), device=dev, generator=gen)
    mine = slab[:16].clone()
    ref.histogram_rows_fixed_ref(packed, gh16, pos16, rid16, 16, MAX_BINS, bits, exponent=k16,
                                 out=slab)
    build_histograms_rows_kernel(packed, gh16, pos16, rid16, 16, MAX_BINS, bits, out=mine,
                                 exponent=k16)
    out_equal["histogram_rows_16"] = torch.equal(mine, slab[:16])
    results["out_slab_bit_for_bit"] = out_equal
    if not all(out_equal.values()):
        raise SystemExit(f"a kernel's out= slab differs from its plain version's: {out_equal}")
    del slab, mine, pos64
    # The exponent kernel against `fixed.exponent` (its plain version) on the
    # edge inputs, alone and after the main (g, h), and on the main inputs;
    # the accumulator it is handed comes back zeroed.
    exp_inputs = {name_e: torch.tensor(rows_e, dtype=torch.float32, device=dev).reshape(-1, 2)
                  for name_e, rows_e in EXPONENT_EDGES}
    exp_inputs.update({f"{k}_after_main": torch.cat([gh, v]) for k, v in exp_inputs.items()},
                      main_gh=gh, main_gh_exact=gh_exact)
    exp_checked = []
    for name_v, gh_e in exp_inputs.items():
        junk = torch.full((8, f, MAX_BINS, 2), -1, dtype=torch.int64, device=dev)
        got_k, want_k = int(fixed_exponent(gh_e, zero=junk)), int(FX.exponent(gh_e))
        exp_checked.append({"input": name_v, "rows": int(gh_e.shape[0]), "k": got_k,
                            "plain_k": want_k, "zeroed": not bool(junk.any())})
    results["fixed_exponent"] = {
        "max_abs_err": float(max(abs(r["k"] - r["plain_k"]) for r in exp_checked)),
        "tolerance": "bit for bit (an int32); the accumulator zeroed", "inputs": exp_checked}
    if any(r["k"] != r["plain_k"] or not r["zeroed"] for r in exp_checked):
        raise SystemExit(f"the exponent kernel disagrees with fixed.exponent: {exp_checked}")
    # A wrapper call without out=: three launches (the exponent with the
    # zeroing, the histogram, the conversion), by the counters (the exponent
    # kernel and the histogram kernel once each) and by the device's own
    # record: the call captured into a CUDA graph, never launched, holds
    # exactly those three kernel nodes in that order and no other node.
    three = {}
    rid1, pos1 = buffers[1]
    gh1 = gh[rid1.to(torch.int64).clamp(max=n - 1)].contiguous()
    for name_c, counter, call in (
            ("histogram_private_kernel", "histogram_private",
             lambda: build_histograms_packed_kernel(packed, gh, levels[8], 8, MAX_BINS, bits)),
            ("histogram_rows_kernel", "histogram_rows",
             lambda: build_histograms_rows_kernel(packed, gh1, pos1, rid1, 1, MAX_BINS, bits)),
            ("histogram_global_kernel", "histogram_packed",
             lambda: histogram_packed(packed, gh, levels[8], 8, MAX_BINS, bits))):
        call()
        torch.cuda.synchronize()
        before = ops.launches()
        call()
        torch.cuda.synchronize()
        after = ops.launches()
        three[name_c] = {"counted": {k: after[k] - before[k] for k in after
                                     if after[k] != before[k]},
                         "device_kernels": device_kernels(call, dev)}
        if three[name_c]["counted"] != {"fixed_exponent": 1, counter: 1} or \
                three[name_c]["device_kernels"] != ["fixed_exponent_kernel", name_c,
                                                    "histogram_dequantise_kernel"]:
            raise SystemExit(f"a histogram call is not three launches: {three[name_c]}")
    results["launches_a_call"] = three
    # Two chunk updates into one int64 slab at the pass's exponent (the
    # streamed path's unit) against one call over the same rows, for both
    # private kernels: the main words split at a word boundary near n / 2,
    # the row-id kernel's 4-parent buffer split by row id there.
    w_all = packed.shape[1]
    half_w = w_all // 2
    cut = half_w * (32 // bits)
    slab_equal = {}
    slab = new_slab(8, f, MAX_BINS, dev)
    k_pass = slab_exponent(slab, gh)
    for lo, hi, wl, wh in ((0, cut, 0, half_w), (cut, n, half_w, w_all)):
        histogram_chunk_update(slab, packed[:, wl:wh].contiguous(), gh[lo:hi], levels[8][lo:hi],
                               8, MAX_BINS, bits, exponent=k_pass)
    slab_equal["histogram_private"] = torch.equal(
        finalize_slab_histogram(slab, 8, MAX_BINS, exponent=k_pass),
        build_histograms_packed_kernel(packed, gh, levels[8], 8, MAX_BINS, bits))
    rid4, pos4 = buffers[4]
    gh4 = gh[rid4.to(torch.int64).clamp(max=n - 1)].contiguous()
    seg = int(torch.searchsorted(rid4, torch.tensor(cut, device=dev, dtype=torch.int32)))
    slab = new_slab(4, f, MAX_BINS, dev)
    k_pass = slab_exponent(slab, gh4)
    for a_, b_, wl, wh, r0 in ((0, seg, 0, half_w, 0), (seg, rid4.shape[0], half_w, w_all, cut)):
        histogram_rows_chunk_update(slab, packed[:, wl:wh].contiguous(), gh4[a_:b_], pos4[a_:b_],
                                    rid4[a_:b_] - r0, 4, MAX_BINS, bits, exponent=k_pass)
    slab_equal["histogram_rows"] = torch.equal(
        finalize_slab_histogram(slab, 4, MAX_BINS, exponent=k_pass),
        build_histograms_rows_kernel(packed, gh4, pos4, rid4, 4, MAX_BINS, bits))
    results["slab_two_chunks_equal_one_call"] = slab_equal
    if not all(slab_equal.values()):
        raise SystemExit(f"two chunk updates into one slab differ from one call: {slab_equal}")
    del slab
    # The subtraction trick's device path (lane-spread counts, scatter
    # compaction, sibling = parent - child) at level 5 of the main matrix,
    # against a full build of the level: exact on integer (g, h); on real
    # (g, h) a sibling carries its parent's rounding, so each child is held
    # to its parent's tolerance.
    local = torch.where(levels[32] < 0, 32, levels[32])
    par = torch.where(local < 32, local // 2, 16).to(torch.int32)
    sub_err = {}
    for name_gh, g in (("exact", gh_exact), ("real", gh)):
        prev = build_histograms_packed_kernel(packed, g, par, 16, MAX_BINS, bits)
        got = _histograms_by_subtraction(dtrain.matrix.as_packed_bins(), g, local,
                                         prev, 32, MAX_BINS)
        want = build_histograms_packed_kernel(packed, g, local, 32, MAX_BINS, bits)
        sub_err[name_gh] = got - want
    tol = counts_and_tolerance(ref.histogram_ref, packed, gh, par, 16, MAX_BINS,
                               bits).repeat_interleave(2, dim=0)
    results["subtraction_level5"] = {
        "exact_max_abs_err": float(sub_err["exact"].abs().max()),
        "max_abs_err": float(sub_err["real"].abs().max()),
        "tolerance": "integer gh exact; real gh the parent's sqrt(rows) tolerance",
    }
    if float(sub_err["exact"].abs().max()) != 0.0 or not bool((sub_err["real"].abs() <= tol).all()):
        raise SystemExit(f"subtraction at level 5 disagrees with a full build: "
                         f"{results['subtraction_level5']}")
    del sub_err, tol, prev
    for name, rows in checked.items():
        results[name] = {
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "tolerance": "integer gh exact; real gh 2e-5 + 4*sqrt(rows)*2^-24*hist(|g|,|h|) "
                         "(skewed and constant words: against the plain version in float64); "
                         "the chunked instantiation against its chunked plain version",
        }

    del constant

    def tie_starts(n_nodes: int) -> torch.Tensor:
        return torch.tensor(TIE_STARTS, device=dev).repeat(-(-n_nodes // len(TIE_STARTS)))[
            :n_nodes]

    def tie_histogram(n_nodes: int) -> torch.Tensor:
        """Integer (g, h), alike in every feature, in which node i's bins below
        k = TIE_STARTS[i % 4] hold g = -(i + 1), the bins from k + TIE_GAP on
        g = +(i + 1), and the run between them nothing: thresholds k - 1 ..
        k + TIE_GAP - 1 split the rows alike and tie exactly, and bin k - 1
        must win."""
        b = torch.arange(MAX_BINS, device=dev)[None, :]
        k = tie_starts(n_nodes)[:, None]
        empty = ((b >= k) & (b < k + TIE_GAP)) | (b == MAX_BINS - 1)  # (n, B)
        scale = torch.arange(1, n_nodes + 1, device=dev, dtype=torch.float32)[:, None]
        g = torch.where(empty, 0.0, torch.where(b < k, -scale, scale))
        h = torch.where(empty, 0.0, 1.0)
        return torch.stack([g, h], dim=-1)[:, None].expand(n_nodes, f, MAX_BINS, 2).contiguous()

    # Bit for bit: the kernel does the plain version's operations in its order.
    scan_inputs = {f"{nn}_nodes": (h, node_sums(h)) for nn, h in level_hists.items()}
    tie = tie_histogram(HIST_NODES[-1])
    scan_inputs["ties"] = (tie, node_sums(tie))
    scan_checked, scan_err = [], 0.0
    for name, (h_, parent_) in scan_inputs.items():
        got = split_scan(h_, parent_, 1.0, 1.0)
        want = ref.split_scan_ref(h_, parent_, 1.0, 1.0)
        same = torch.equal(got, want)
        scan_err = max(scan_err, float(torch.where(got == want, 0.0, got - want).abs().max()))
        if name == "ties":
            lowest = (tie_starts(h_.shape[0]) - 1).float()[:, None].expand(got.shape[:2])
            same = same and torch.equal(got[..., 1], lowest)
        scan_checked.append({"input": name, "shape": list(h_.shape[:3]), "bit_identical": same})
        if not same:
            raise SystemExit(f"split_scan kernel is not bit-identical to its plain "
                             f"version on {name}")

    def scan_variants(h_, parent_):
        """The extended scan's inputs for a level: constraints cycling -1, 0,
        +1 over the features; node bounds cycling through ±inf, a band of 5%
        around the node's weight -G/(H+1) (the children's weights clip),
        one-sided at it, and pinched at it; a (F,) and an (n, F) mask of
        about half the problems, node 0 wholly masked."""
        nn = h_.shape[0]
        w0 = -parent_[:, 0] / (parent_[:, 1] + 1.0)
        band = 0.05 * w0.abs().clamp(min=1e-3)
        inf = torch.full_like(w0, float("inf"))
        choices = torch.stack([torch.stack(pair, dim=1) for pair in (
            (-inf, inf), (w0 - band, w0 + band), (-inf, w0), (w0, inf), (w0, w0))])
        nodes = torch.arange(nn, device=dev)
        bounds = choices[nodes % 5, nodes].contiguous()
        mono = (torch.arange(f, device=dev) % 3 - 1).to(torch.int8)
        mask = torch.rand(nn, f, device=dev, generator=gen) < 0.5
        mask[0] = False
        return {"monotone": dict(monotone=mono, node_bounds=bounds),
                "mask_f": dict(feature_mask=mask[-1]), "mask_nf": dict(feature_mask=mask),
                "mask_and_monotone": dict(feature_mask=mask, monotone=mono, node_bounds=bounds)}

    for name, (h_, parent_) in scan_inputs.items():
        for variant, kw in scan_variants(h_, parent_).items():
            got = split_scan(h_, parent_, 1.0, 1.0, **kw)
            want = ref.split_scan_ref(h_, parent_, 1.0, 1.0, **kw)
            same = torch.equal(got, want)
            scan_err = max(scan_err, float(torch.where(got == want, 0.0, got - want)
                                           .nan_to_num(nan=float("inf")).abs().max()))
            if "feature_mask" in kw:
                off = ~kw["feature_mask"].expand(got.shape[:2])
                masked = torch.tensor([float("-inf"), 0, 0, 0, 0], device=dev)
                same = same and bool((got[off] == masked).all())
            scan_checked.append({"input": name, "variant": variant,
                                 "shape": list(h_.shape[:3]), "bit_identical": same})
            if not same:
                raise SystemExit(f"split_scan kernel ({variant}) is not bit-identical to its "
                                 f"plain version on {name}")
    results["split_scan"] = {"max_abs_err": scan_err, "tolerance": "bit-identical",
                             "inputs": scan_checked}

    def cuts_inputs(xx):
        finite_ = torch.isfinite(xx)
        return (torch.sort(torch.where(finite_, xx, float("inf")), dim=0).values,
                finite_.sum(dim=0, dtype=torch.int32))

    # The training matrix, and a copy whose columns 1-4 are tied (rounded),
    # constant, all missing, and missing but for one value: the kernel's
    # in-order compaction must be bit for bit the plain version's sort.
    xt = torch.as_tensor(x_tr, device=dev)
    odd = xt[:20_000].clone()
    odd[:, 1] = torch.round(odd[:, 1])
    odd[:, 2] = 0.5
    odd[:, 3] = float("nan")
    odd[:, 4] = float("nan")
    odd[7, 4] = 1.25
    srt, n_valid = cuts_inputs(xt)
    cut_checks = {}
    for name_c, (srt_c, nv_c) in (("higgs", (srt, n_valid)), ("odd", cuts_inputs(odd))):
        want = ref.quantile_cuts_ref(srt_c, nv_c, MAX_BINS)
        cut_checks[name_c] = torch.equal(quantile_cuts_from_sorted(srt_c, nv_c, MAX_BINS), want)
        if not cut_checks[name_c]:
            raise SystemExit(f"quantile_cuts kernel is not bit-identical to its plain "
                             f"version on the {name_c} columns")
    del odd
    results["quantile_cuts"] = {"max_abs_err": 0.0, "tolerance": "bit-identical",
                                "inputs": cut_checks}

    xte = torch.as_tensor(x_te, device=dev)
    targs = (ens.feature, ens.threshold, ens.default_left, ens.leaf_value,
             ens.is_leaf, xte, ens.n_classes, DEPTH)
    got = ensemble_margins_kernel(ens.nodes, xte, ens.n_classes, DEPTH)
    want = ref.ensemble_margins_ref(*targs)
    err = float((got - want).abs().max())

    def check_traversal(arena, x_, k, depth, chunk=100_000):
        """The kernel on packed nodes against the plain walk over the arena
        fields, bit for bit (rows are independent: the plain version runs on
        row chunks to bound its memory). Returns the packed nodes."""
        nodes = pack_nodes(*arena)
        got_ = ensemble_margins_kernel(nodes, x_, k, depth)
        for r0 in range(0, x_.shape[0], chunk):
            want_ = ref.ensemble_margins_ref(*arena, x_[r0:r0 + chunk], k, depth)
            if not torch.equal(got_[r0:r0 + chunk], want_):
                raise SystemExit(f"ensemble_traversal disagrees at {arena[0].shape[0]} trees, "
                                 f"depth {depth}, {k} classes: "
                                 f"{float((got_[r0:r0 + chunk] - want_).abs().max())}")
        return nodes

    # Models past the staged route's shared memory: the arenas read through
    # L2, or the classes tiled over the grid; and a served model's size. Each
    # class sums in tree order on both sides, so these must agree bit for bit.
    deep, serving = [], []
    for shapes, xs_, rows_out in (
            (tuple((*s, 0.2) for s in DEEP_TRAVERSALS), xte, deep),
            (tuple((t, d, k, n, share) for t, d, k, share in SERVING), xt, serving)):
        for n_trees, depth, k, rows, share in shapes:
            nodes = check_traversal(random_ensemble(n_trees, depth, f, gen, share), xs_[:rows],
                                    k, depth)
            rows_out.append({"trees": n_trees, "depth": depth, "classes": k, "rows": rows,
                             "leaf_share": share, "nodes": nodes, "max_abs_err": 0.0,
                             "plan": list(traversal_plan(n_trees, nodes.shape[1], k, f,
                                                         KB.device_limits(0).smem_block))})
    results["ensemble_traversal"] = {"max_abs_err": err, "tolerance": "bit-identical "
                                     "(main, deep and wide models, serving shapes)",
                                     "deep_and_wide": [{k: v for k, v in r.items() if k != "nodes"}
                                                       for r in deep]}
    if err != 0.0:
        raise SystemExit(f"ensemble_traversal kernel disagrees: {err}")

    def decompress_err(words, b, rows, got, first_row=0) -> int:
        """Largest |kernel - plain| over the rows from `first_row` on, the
        plain version on word-aligned slices (its int64 intermediates of a
        whole Bosch-shaped matrix would take tens of GB)."""
        spw_ = 32 // b
        step = max(1, DECOMPRESS_CHECK_ELEMENTS // words.shape[0] // spw_) * spw_
        err_, r0 = 0, first_row // spw_ * spw_
        while r0 < rows:
            r1 = min(rows, r0 + step)
            want_ = ref.decompress_ref(words[:, r0 // spw_:-(-r1 // spw_)], b, r1 - r0)
            err_ = max(err_, int((got[r0:r1].to(torch.int64) - want_).abs().max()))
            r0 = r1
        return err_

    # decompress: the training matrix (8-bit symbols) and 4-bit symbols at an
    # odd row count, against the plain unpack and against the bins packed;
    # then random words at DECOMPRESS_SHAPES.
    n_odd = n - 1 if n % 2 == 0 else n
    bins4 = torch.randint(0, 16, (n_odd, f), device=dev, generator=gen, dtype=torch.int32)
    dec_checked = []
    for name_d, words, b, rows in (("main", packed, bits, n), ("bins_4", pack(bins4, 4), 4,
                                                                n_odd)):
        got = decompress(words, b, rows)
        err_d = decompress_err(words, b, rows, got)
        if name_d == "bins_4":
            err_d = max(err_d, int((got - bins4).abs().max()))
        dec_checked.append({"shape": name_d, "rows": rows, "features": f, "bits": b,
                            "max_abs_err": float(err_d)})
    del bins4, got
    dec_words = {}  # the random words of the timed shapes, kept for the time phase
    for name_d, rows, feats, b, timed in DECOMPRESS_SHAPES:
        words = torch.randint(-2**31, 2**31, (feats, -(-rows // (32 // b))), device=dev,
                              generator=gen, dtype=torch.int32)
        got = decompress(words, b, rows)
        first = 0 if timed else 2**31 // feats  # the rows past element 2^31
        dec_checked.append({"shape": name_d, "rows": rows, "features": feats, "bits": b,
                            "checked_from_row": first,
                            "max_abs_err": float(decompress_err(words, b, rows, got, first))})
        del got
        if timed:
            dec_words[name_d] = (words, rows, b)
        del words
        torch.cuda.empty_cache()
    dec_err = max(r["max_abs_err"] for r in dec_checked)
    results["decompress"] = {"max_abs_err": dec_err, "tolerance": "exact", "shapes": dec_checked}
    if dec_err != 0:
        raise SystemExit(f"decompress kernel disagrees: {dec_checked}")
    # The pairwise gradient: on the rank fit's training scores after
    # RANK_CHECK_ROUNDS rounds, at PAIR_GROUPS' query sizes, and on queries of
    # 120 rows with one relevance everywhere (every h exactly the 1e-6 floor)
    # and with tied scores. Both sum float32 terms in float64, in two orders.
    rank_grouping = ops.query_groups(d_rank.group_ids)

    def pair_inputs(size, rows, labels=5, tied=False):
        ids = torch.arange(rows, device=dev, dtype=torch.int32) // size
        ids = ids[torch.randperm(rows, device=dev, generator=gen)] * 3 + 1
        sc = torch.randn(rows, device=dev, generator=gen) * 2
        lab = torch.randint(0, labels, (rows,), device=dev, generator=gen).to(torch.float32)
        return (torch.round(sc) if tied else sc), lab, ops.query_groups(ids)

    # Queries just above each size at which the kernel's work changes hands:
    # a window's warp, a block, and a spread query of three chunks and a row.
    pair_group_inputs = {name: pair_inputs(size, rows) for name, size, rows in PAIR_GROUPS}
    pair_sets = {"rank_scores": (rank_scores, d_rank.label, rank_grouping),
                 **pair_group_inputs,
                 **{f"above_{k}": pair_inputs(size + 1, 50_000 // (size + 1) * (size + 1))
                    for k, size in (("window", KP.WINDOW_ROWS), ("block", KP.BLOCK_ROWS),
                                    ("three_chunks", 3 * KP.CHUNK_ROWS))},
                 "equal_relevance": pair_inputs(120, 50_040, labels=1),
                 "tied_scores": pair_inputs(120, 50_040, tied=True)}
    pair_checked = []
    for name_p, (sc, lab, grouping) in pair_sets.items():
        got = pairwise_grad(sc, lab, *grouping)
        # Run to run: the same bits from a second call (no float atomics;
        # every sum in an order fixed by the shapes).
        same_bits = bool(torch.equal(got, pairwise_grad(sc, lab, *grouping)))
        terms = ref.pairwise_terms_ref(sc, lab, *grouping)
        want = ref.pairwise_grad_ref(sc, lab, *grouping)
        mag = torch.stack([terms[:, 0] + terms[:, 1], terms[:, 2]], dim=1)
        diff = (got - want).abs()
        row = {"input": name_p, "rows": int(sc.shape[0]),
               "max_abs_err": float(diff.max()),
               "max_err_over_1_plus_terms": float((diff / (1 + mag)).max()),
               "ok": bool((diff <= PAIR_RTOL * (1 + mag)).all()) and same_bits,
               "same_bits_two_calls": same_bits}
        if name_p == "equal_relevance":
            row["ok"] &= bool((got[:, 0] == 0).all()) and bool((got[:, 1] == 1e-6).all())
        pair_checked.append(row)
        if not row["ok"]:
            raise SystemExit(f"pairwise_grad disagrees with its plain version: {row}")
    del pair_sets, terms, want, got
    results["pairwise_grad"] = {
        "max_abs_err": max(r["max_abs_err"] for r in pair_checked),
        "tolerance": f"{PAIR_RTOL} * (1 + the row's summed term magnitudes); h exactly "
                     "1e-6 where no pair is comparable; two calls bit for bit",
        "inputs": pair_checked}
    emit({"phase": "check", **results, **{f"{k}_levels": v for k, v in checked.items()}})

    # --- 21. times -------------------------------------------------------------
    def bound(nbytes: float, nops: float) -> tuple[float, str]:
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / FP32_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    def library_scatter(bins_rows, pos, src, n_nodes):
        """One `scatter_add_` on the flat index ((pos * F) + f) * B + bin, as
        a function of (output, index, source), and its inputs."""
        pos = pos.to(torch.int64)
        pos = torch.where((pos >= 0) & (pos < n_nodes), pos, n_nodes)
        idx = (pos[:, None] * f + torch.arange(f, device=dev)[None, :]) * MAX_BINS \
            + bins_rows.to(torch.int64)
        idx = idx.reshape(-1, 1).expand(-1, 2)
        src = src[:, None, :].expand(-1, f, 2).reshape(-1, 2)
        out = torch.zeros(((n_nodes + 1) * f * MAX_BINS, 2), device=dev)
        return lambda: out.scatter_add_(0, idx, src)

    w = packed.shape[1]
    limits = KB.device_limits(0)

    def plan_reading(kind: str, n_items: int, nodes: int) -> dict:
        """A private kernel's launch plan, and the resident blocks per SM that
        the CUDA runtime allows it (registers and threads included)."""
        plan = (private_plan(n_items, f, nodes, MAX_BINS, bits, limits) if kind == "private"
                else launch_plan(n_items, f, nodes, MAX_BINS, limits, MIN_BLOCKS_PER_SM))
        return {"node_tile": plan.node_tile, "feat_group": plan.feat_group,
                "threads": plan.threads,
                "items_per_block": plan.words_per_block, "smem_bytes": plan.smem_bytes,
                "blocks_per_sm_by_smem": plan.blocks_per_sm,
                "blocks_per_sm_occupancy": occupancy(kind, plan, bits)}

    def private_at(plan, words_, gh_, pos, nn):
        """#1 under `plan` (a `HistogramPlan`), through the library itself,
        with what its wrapper adds (the exponent, the zeroed int64
        accumulator, the conversion pass): the launch is not counted."""
        acc = torch.empty((nn, f, MAX_BINS, 2), dtype=torch.int64, device=dev)
        k_ = fixed_exponent(gh_, zero=acc)
        KB.check(KB.lib().rt_histogram_private(
            words_.data_ptr(), gh_.data_ptr(), pos.data_ptr(), acc.data_ptr(), k_.data_ptr(),
            n, f, w, nn, MAX_BINS, bits, plan.node_tile, plan.feat_group,
            plan.words_per_block, plan.threads, 0, 0, KB.stream(dev)),
            "histogram_private")
        return dequantise_kernel(acc, k_)

    # With (g, h) all zero the privatised kernel does every shared-memory
    # atomic but its private histograms stay zero, and the flush skips zero
    # entries: the difference of the two times is what the flush costs.
    zero_gh = torch.zeros_like(gh)
    hist_rows, rows_rows = [], []
    spw = 32 // bits
    for words_, data in ((packed, "higgs"), (skewed, "skewed")):
        dense_ = dense if data == "higgs" else unpack(words_, bits, n)
        for nn in HIST_NODES:
            pos = levels[nn]
            active = int(((pos >= 0) & (pos < nn)).sum())
            b_ms, b_by = bound(f * w * 4 + n * 8 + n * 4 + nn * f * MAX_BINS * 8,
                               2 * active * f)
            hargs = (words_, gh, pos, nn, MAX_BINS, bits)
            # #1 under the plans of 1, 2 and 3 512-thread blocks per SM (1: a
            # block fills its opt-in shared memory) and under its own (one
            # 1024-thread block per SM), each first checked exact against the
            # wrapper on integer (g, h); a plan met twice is timed once.
            plans = {**{f"blocks_per_sm_{t}": launch_plan(w, f, nn, MAX_BINS, limits, t)
                        for t in (3, 2, 1)},
                     "shipped": private_plan(w, f, nn, MAX_BINS, bits, limits)}
            want_exact = build_histograms_packed_kernel(words_, gh_exact, *hargs[2:])
            plan_ms: dict[tuple, float] = {}
            for name_p, plan_p in plans.items():
                if plan_p in plan_ms:
                    continue
                if not torch.equal(private_at(plan_p, words_, gh_exact, pos, nn), want_exact):
                    raise SystemExit(f"histogram_private under plan {name_p} disagrees at "
                                     f"{nn} nodes on {data}")
                plan_ms[plan_p] = time_ms(lambda: private_at(plan_p, words_, gh, pos, nn))
            del want_exact
            row = {
                "n_nodes": nn, "data": data,
                "private_ms": time_ms(lambda: build_histograms_packed_kernel(*hargs)),
                "private_plan": "shipped",
                "private_back_to_back_ms": back_to_back_ms(
                    lambda: build_histograms_packed_kernel(*hargs)),
                "private_plans": {k: {"plan": [v.node_tile, v.feat_group, v.words_per_block,
                                               v.smem_bytes, v.threads],
                                      "ms": plan_ms[v]} for k, v in plans.items()},
                "packed_ms": time_ms(lambda: histogram_packed(*hargs)),
                "library_ms": time_ms(library_scatter(dense_, pos, gh, nn), iters=5),
                "bound_ms": b_ms, "bound_by": b_by,
            }
            if data == "higgs":
                row.update(
                    private_zero_gh_ms=time_ms(lambda: build_histograms_packed_kernel(
                        packed, zero_gh, pos, nn, MAX_BINS, bits)),
                    plain_ms=time_ms(lambda: ref.histogram_ref(*hargs), iters=5),
                    plan=plan_reading("private", w, nn),
                    packed_blocks_per_sm_occupancy=occupancy("packed", None, bits))
            hist_rows.append(row)

        for npar in ROW_PARENTS:
            rid, pos = buffers[npar]
            valid = pos < npar
            gh_sel = gh[rid.to(torch.int64).clamp(max=n - 1)]
            rargs = (words_, gh_sel, pos, rid, npar, MAX_BINS, bits)
            # Bytes this run's data needs: the words of the valid slots' rows,
            # each (g, h), position and row id once, the histogram once.
            n_words_touched = int(torch.unique(rid[valid].to(torch.int64) // spw).numel())
            m = rid.shape[0]
            b_ms, b_by = bound(f * n_words_touched * 4 + m * (8 + 4 + 4)
                               + npar * f * MAX_BINS * 8, 2 * int(valid.sum()) * f)
            row = {
                "n_parents": npar, "data": data, "slots": m, "valid_slots": int(valid.sum()),
                "words_touched": n_words_touched,
                "ms": time_ms(lambda: build_histograms_rows_kernel(*rargs)),
                "back_to_back_ms": back_to_back_ms(lambda: build_histograms_rows_kernel(*rargs)),
                "library_ms": time_ms(library_scatter(
                    dense_[rid.to(torch.int64).clamp(max=n - 1)], pos, gh_sel, npar), iters=5),
                "bound_ms": b_ms, "bound_by": b_by,
            }
            if data == "higgs":
                row["plain_ms"] = time_ms(lambda: ref.histogram_rows_ref(*rargs), iters=5)
                row["plan"] = plan_reading("rows", m, npar)
            if data == "higgs" and npar == ROW_PARENTS[-1]:
                # The same slots in a random order: what the buffer's row order
                # (neighbouring slots sharing a word) is worth.
                perm = torch.randperm(m, device=dev, generator=gen)
                shuffled = (packed, gh_sel[perm].contiguous(), pos[perm].contiguous(),
                            rid[perm].contiguous(), npar, MAX_BINS, bits)
                row["shuffled_slots_ms"] = time_ms(
                    lambda: build_histograms_rows_kernel(*shuffled))
            rows_rows.append(row)
        del dense_
    emit({"phase": "time", "histogram_levels": hist_rows})
    emit({"phase": "time", "histogram_rows_levels": rows_rows})
    # #1 at 32 nodes, where it sits closest to one scatter_add_: the two
    # alternating in this call, ALTERNATING_ROUNDS rounds of 20 events each,
    # so that the verdict is not one reading's.
    alternating = []
    for words_, data in ((packed, "higgs"), (skewed, "skewed")):
        dense_ = dense if data == "higgs" else unpack(words_, bits, n)
        hargs = (words_, gh, levels[32], 32, MAX_BINS, bits)
        library = library_scatter(dense_, levels[32], gh, 32)
        tree_ms, lib_ms = [], []
        for _ in range(ALTERNATING_ROUNDS):
            tree_ms.append(time_ms(lambda: build_histograms_packed_kernel(*hargs)))
            lib_ms.append(time_ms(library))
        alternating.append({"n_nodes": 32, "data": data, "private_ms": tree_ms,
                            "library_ms": lib_ms,
                            "private_at_or_below_every_round": all(
                                t <= b for t, b in zip(tree_ms, lib_ms))})
        del dense_, library
    emit({"phase": "time", "histogram_32_alternating": alternating})
    # The chunked instantiations beside the flat ones on the same rows, back
    # to back and by events: #1 at 1 and 8 nodes, the row-id kernel at 1 and
    # 16 parents; each bound counts the words it must read (#1: the words
    # that hold real rows, ceil(rows / spw) a chunk, since a word of padding
    # alone is never loaded; the row-id kernel: the words of the valid
    # slots' rows in that layout).
    chunked_rows = []
    for cr in (ext_chunk, EXT_ODD_CHUNK_ROWS):
        stack_ = ext_stacks[cr].packed
        n_ch, _, wpc = stack_.shape
        real_words = sum(-(-min(cr, n - c * cr) // spw) for c in range(n_ch))
        for nn in (1, 8):
            pos = levels[nn]
            ops_ = 2 * int(((pos >= 0) & (pos < nn)).sum()) * f
            hist_bytes = n * 12 + nn * f * MAX_BINS * 8
            flat_b, by = bound(f * w * 4 + hist_bytes, ops_)
            chunk_b, _ = bound(f * real_words * 4 + hist_bytes, ops_)
            flat_fn = functools.partial(build_histograms_packed_kernel, packed, gh, pos, nn,
                                        MAX_BINS, bits)
            chunk_fn = functools.partial(build_histograms_packed_kernel, stack_, gh, pos, nn,
                                         MAX_BINS, bits, cr)
            chunked_rows.append({
                "kernel": "histogram_private", "chunk_rows": cr, "n_chunks": n_ch,
                "n_nodes": nn, "flat_ms": time_ms(flat_fn), "chunked_ms": time_ms(chunk_fn),
                "chunked_plain_ms": time_ms(functools.partial(
                    ref.histogram_chunked_ref, stack_, gh, pos, nn, MAX_BINS, bits, cr), iters=5),
                "flat_back_to_back_ms": back_to_back_ms(flat_fn),
                "chunked_back_to_back_ms": back_to_back_ms(chunk_fn),
                "flat_bound_ms": flat_b, "chunked_bound_ms": chunk_b, "bound_by": by})
        for npar in (1, 16):
            rid, pos = buffers[npar]
            valid = pos < npar
            gh_sel = gh[rid.to(torch.int64).clamp(max=n - 1)]
            r64 = rid[valid].to(torch.int64)
            flat_words = int(torch.unique(r64 // spw).numel())
            chunk_words = int(torch.unique((r64 // cr) * wpc + (r64 % cr) // spw).numel())
            m = rid.shape[0]
            rest_bytes = m * (8 + 4 + 4) + npar * f * MAX_BINS * 8
            ops_ = 2 * int(valid.sum()) * f
            flat_b, by = bound(f * flat_words * 4 + rest_bytes, ops_)
            chunk_b, _ = bound(f * chunk_words * 4 + rest_bytes, ops_)
            flat_fn = functools.partial(build_histograms_rows_kernel, packed, gh_sel, pos, rid,
                                        npar, MAX_BINS, bits)
            chunk_fn = functools.partial(build_histograms_rows_kernel, stack_, gh_sel, pos, rid,
                                         npar, MAX_BINS, bits, cr)
            chunked_rows.append({
                "kernel": "histogram_rows", "chunk_rows": cr, "n_chunks": n_ch,
                "n_parents": npar, "flat_ms": time_ms(flat_fn), "chunked_ms": time_ms(chunk_fn),
                "chunked_plain_ms": time_ms(functools.partial(
                    ref.histogram_rows_chunked_ref, stack_, gh_sel, pos, rid, npar, MAX_BINS,
                    bits, cr), iters=5),
                "flat_back_to_back_ms": back_to_back_ms(flat_fn),
                "chunked_back_to_back_ms": back_to_back_ms(chunk_fn),
                "flat_bound_ms": flat_b, "chunked_bound_ms": chunk_b, "bound_by": by})
    emit({"phase": "time", "histogram_chunked": chunked_rows})
    del ext_stacks
    del dense, skewed

    # The split scan at each checked level, beside an empty launch on the same
    # stream: the floor under any launch's time.
    def empty_launch():
        KB.check(KB.lib().rt_empty_launch(KB.stream(dev)), "empty_launch")

    scan_rows = []
    for nn in HIST_NODES:
        h_, parent_ = scan_inputs[f"{nn}_nodes"]
        nb = h_.shape[2]
        # Prefix sums (2 adds per candidate) and two gain evaluations of 11 flops.
        b_ms, b_by = bound(nn * f * nb * 8 + nn * 8 + nn * f * 5 * 4,
                           nn * f * (nb - 2) * (2 + 2 * 11))
        scan_rows.append({
            "n_nodes": nn, "shape": list(h_.shape[:3]),
            "ms": time_ms(lambda: split_scan(h_, parent_, 1.0, 1.0)),
            "back_to_back_ms": back_to_back_ms(lambda: split_scan(h_, parent_, 1.0, 1.0)),
            "plain_ms": time_ms(lambda: ref.split_scan_ref(h_, parent_, 1.0, 1.0), iters=5),
            "bound_ms": b_ms, "bound_by": b_by})
    emit({"phase": "time", "split_scan_levels": scan_rows,
          "empty_launch_ms": time_ms(empty_launch),
          "empty_launch_back_to_back_ms": back_to_back_ms(empty_launch)})
    # The constrained and the masked scan at the same levels, each beside the
    # unconstrained one in the same loop. Bounds: the constrained scan adds
    # the constraints' and bounds' bytes and 60 operations a candidate (two
    # clipped weights, two gains at weight and the sign test, each missing
    # direction); the masked one reads only the kept problems' rows, plus
    # the mask.
    variant_rows = []
    for nn in HIST_NODES:
        h_, parent_ = scan_inputs[f"{nn}_nodes"]
        nb = h_.shape[2]
        kw_all = scan_variants(h_, parent_)
        half = torch.rand(nn, f, device=dev, generator=gen) < 0.5
        kept = int(half.sum())
        row = {"n_nodes": nn, "kept_problems": kept, "unconstrained_back_to_back_ms":
               back_to_back_ms(lambda: split_scan(h_, parent_, 1.0, 1.0))}
        for variant, kw, nbytes, nops in (
                ("monotone", kw_all["monotone"],
                 nn * f * nb * 8 + nn * 8 + f + nn * 8 + nn * f * 5 * 4,
                 nn * f * (nb - 2) * (2 + 2 * 30)),
                ("masked", dict(feature_mask=half.to(torch.uint8)),
                 kept * nb * 8 + nn * 8 + nn * f + nn * f * 5 * 4,
                 kept * (nb - 2) * (2 + 2 * 11))):
            b_ms, b_by = bound(nbytes, nops)
            row[variant] = {
                "ms": time_ms(lambda: split_scan(h_, parent_, 1.0, 1.0, **kw)),
                "back_to_back_ms": back_to_back_ms(lambda: split_scan(h_, parent_, 1.0, 1.0,
                                                                      **kw)),
                "plain_ms": time_ms(lambda: ref.split_scan_ref(h_, parent_, 1.0, 1.0, **kw),
                                    iters=5),
                "bound_ms": b_ms, "bound_by": b_by}
        variant_rows.append(row)
    emit({"phase": "time", "split_scan_variants": variant_rows})

    nvb_cuts = MAX_BINS - 2
    top = next(r for r in hist_rows
               if r["data"] == "higgs" and r["n_nodes"] == HIST_NODES[-1])
    top_rows = next(r for r in rows_rows
                    if r["data"] == "higgs" and r["n_parents"] == ROW_PARENTS[-1])

    def traversal_at(nodes, x_, k, depth, plan):
        """The traversal under `plan` (class tile, trees a stage, row tile),
        through the library itself: the launch is not counted."""
        out = torch.empty((x_.shape[0], k), device=dev)
        KB.check(KB.lib().rt_ensemble_margins(
            nodes.data_ptr(), x_.data_ptr(), out.data_ptr(), *nodes.shape[:2], *x_.shape, k,
            depth, *plan, TRAVERSAL_THREADS, KB.stream(dev)), "ensemble_margins")
        return out

    def levels_visited(nodes, x_, depth, chunk=100_000) -> int:
        """(row, tree) levels the walk descends on this run's rows: the
        traversal's work, which the data decides (a walk stops at a leaf)."""
        value, feature, default_left, is_leaf = node_fields(nodes)
        total = 0
        for r0 in range(0, x_.shape[0], chunk):
            xc = x_[r0:r0 + chunk]
            node = torch.zeros((nodes.shape[0], xc.shape[0]), dtype=torch.int64, device=dev)
            row = torch.arange(xc.shape[0], device=dev)[None, :]
            for _ in range(depth):
                inner = ~torch.gather(is_leaf, 1, node)
                total += int(inner.sum())
                v = xc[row, torch.gather(feature, 1, node)]
                left = torch.where(torch.isnan(v), torch.gather(default_left, 1, node),
                                   v <= torch.gather(value, 1, node))
                node = torch.where(inner, torch.where(left, 2 * node + 1, 2 * node + 2), node)
        return total

    def traversal_bound(nodes, x_, k, depth) -> tuple[float, str]:
        """Rows read once, the packed arenas once, margins written once; a
        compare, a NaN test and a child index per level visited, one add per
        (row, tree)."""
        rows_, feats = x_.shape
        return bound(rows_ * feats * 4 + nodes.numel() * 4 + rows_ * k * 4,
                     3 * levels_visited(nodes, x_, depth) + rows_ * nodes.shape[0])

    # The main path's traversal also with every arena read through L2
    # (trees_blk 0), as deeper models read them, and with the other source
    # of its rows (the row tile or global memory), through the library
    # itself (not counted): what staging the arenas and the rows is worth.
    main_plan = traversal_plan(ens.n_trees, ens.nodes.shape[1], ens.n_classes, f,
                               KB.device_limits(0).smem_block)
    route_plans = {"through_l2": (main_plan.class_tile, 0, main_plan.row_tile),
                   "rows_from_global" if main_plan.row_tile else "row_tile": (
                       main_plan.class_tile, main_plan.trees_blk, 1 - main_plan.row_tile)}
    main_out = ensemble_margins_kernel(ens.nodes, xte, ens.n_classes, DEPTH)
    for name_r, plan_r in route_plans.items():
        if not torch.equal(traversal_at(ens.nodes, xte, ens.n_classes, DEPTH, plan_r), main_out):
            raise SystemExit(f"the traversal {name_r} differs from the wrapper's plan")
    # The cut selection beside the call it sits in: compute_cuts_op now ends
    # with the kernel, and the candidate sort it ran before is timed alone.
    cand = ref.quantile_cuts_ref(srt, n_valid, MAX_BINS)
    times = {
        "histogram_private": {"ms": top["private_ms"],
                              **{k: top[k] for k in ("plain_ms", "library_ms",
                                                     "bound_ms", "bound_by")}},
        "histogram_packed": {"ms": top["packed_ms"],
                             **{k: top[k] for k in ("plain_ms", "library_ms",
                                                    "bound_ms", "bound_by")}},
        "histogram_rows": {k: top_rows[k] for k in ("ms", "plain_ms", "library_ms",
                                                    "bound_ms", "bound_by")},
        "split_scan": {k: scan_rows[-1][k] for k in ("ms", "plain_ms", "bound_ms",
                                                      "bound_by")} | {"library_ms": None},
        "quantile_cuts": {
            "ms": time_ms(lambda: quantile_cuts_from_sorted(srt, n_valid, MAX_BINS)),
            "back_to_back_ms": back_to_back_ms(
                lambda: quantile_cuts_from_sorted(srt, n_valid, MAX_BINS)),
            "plain_ms": time_ms(lambda: ref.quantile_cuts_ref(srt, n_valid, MAX_BINS), iters=5),
            "library_ms": None,
        },
        "ensemble_traversal": {
            "ms": time_ms(lambda: ensemble_margins_kernel(ens.nodes, xte, ens.n_classes, DEPTH),
                          iters=50),
            "plain_ms": time_ms(lambda: ref.ensemble_margins_ref(*targs), iters=5),
            "library_ms": None,
        },
        "decompress": {
            "plain_ms": time_ms(lambda: ref.decompress_ref(packed, bits, n), iters=5),
            "library_ms": None,
        },
    }
    # Two sorted values gathered per candidate, the counts, the cuts out.
    b_ms, b_by = bound(f * nvb_cuts * 2 * 4 + f * 4 + f * nvb_cuts * 4,
                       f * nvb_cuts * 6)
    times["quantile_cuts"].update(bound_ms=b_ms, bound_by=b_by)
    b_ms, b_by = traversal_bound(ens.nodes, xte, ens.n_classes, DEPTH)
    times["ensemble_traversal"].update(bound_ms=b_ms, bound_by=b_by)
    # The exponent kernel at the main path's root call: every row's (g, h)
    # read once, the root's int64 accumulator zeroed, k written; two masks
    # and two maxima a row. Its plain version is `fixed.exponent` and the
    # zeroing, the wrapper's launches before this kernel.
    root_acc = torch.empty((1, f, MAX_BINS, 2), dtype=torch.int64, device=dev)
    b_ms, b_by = bound(n * 8 + root_acc.numel() * 8 + 4, 4 * n)
    times["fixed_exponent"] = {
        "ms": time_ms(lambda: fixed_exponent(gh, zero=root_acc)),
        "back_to_back_ms": back_to_back_ms(lambda: fixed_exponent(gh, zero=root_acc)),
        "plain_ms": time_ms(lambda: (FX.exponent(gh), root_acc.zero_())),
        "plain_back_to_back_ms": back_to_back_ms(lambda: (FX.exponent(gh), root_acc.zero_())),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}

    def decompress_times(words_, rows_, b) -> dict:
        """Events and back to back, beside the bound (the words read once, one
        int32 written per (row, feature); a shift and a mask per element) and
        `copy_` of a tensor whose reads and writes together are as many
        bytes."""
        feats, n_words = words_.shape
        nbytes = feats * n_words * 4 + rows_ * feats * 4
        b_ms_, b_by_ = bound(nbytes, 2 * rows_ * feats)
        src = torch.empty(nbytes // 16, dtype=torch.int64, device=dev)
        dst = torch.empty_like(src)
        row = {"rows": rows_, "features": feats, "bits": b,
               "ms": time_ms(lambda: decompress(words_, b, rows_)),
               "back_to_back_ms": back_to_back_ms(lambda: decompress(words_, b, rows_)),
               "bound_ms": b_ms_, "bound_by": b_by_,
               "copy_ms": time_ms(lambda: dst.copy_(src)),
               "copy_back_to_back_ms": back_to_back_ms(lambda: dst.copy_(src))}
        del src, dst
        torch.cuda.empty_cache()
        return row

    times["decompress"].update(decompress_times(packed, n, bits))
    dec_rows = {name_d: decompress_times(*v) for name_d, v in dec_words.items()}
    del dec_words

    emit({"phase": "time", "quantile_cuts": {
        "shape": list(srt.shape),
        "ms": times["quantile_cuts"]["ms"],
        "back_to_back_ms": times["quantile_cuts"]["back_to_back_ms"],
        "compute_cuts_op_back_to_back_ms": back_to_back_ms(
            lambda: ops.compute_cuts_op(xt, MAX_BINS), launches=20),
        "candidate_sort_back_to_back_ms": back_to_back_ms(
            lambda: torch.sort(cand, dim=-1)),
        "empty_launch_back_to_back_ms": back_to_back_ms(empty_launch)}})
    for rows_out, xs_ in ((deep, xte), (serving, xt)):
        for r in rows_out:
            nodes, x_ = r.pop("nodes"), xs_[:r["rows"]]
            r["ms"] = time_ms(lambda: ensemble_margins_kernel(nodes, x_, r["classes"],
                                                              r["depth"]), iters=10)
            r["bound_ms"], r["bound_by"] = traversal_bound(nodes, x_, r["classes"],
                                                           r["depth"])
    emit({"phase": "time", "ensemble_traversal_routes": {
        "rows": HELD_OUT, "trees": ens.n_trees, "max_depth": DEPTH, "plan": list(main_plan),
        "wrapper_ms": times["ensemble_traversal"]["ms"],
        **{f"{k}_ms": time_ms(lambda: traversal_at(ens.nodes, xte, ens.n_classes, DEPTH, v),
                              iters=50) for k, v in route_plans.items()}},
        "ensemble_traversal_deep_and_wide": deep, "ensemble_traversal_serving": serving})
    emit({"phase": "time", "decompress_shapes": {"main": times["decompress"], **dec_rows}})
    # The pairwise kernel at the rank fit's shape: its bound counts this
    # data's unordered pairs, as the function needs them (a label compare a
    # pair; a pair whose labels differ a subtraction, exp, add, reciprocal,
    # 1 - rho, rho (1 - rho) and four adds, to both rows' g and h), and 28
    # bytes a row; beside it the bound of the pairs' exp and reciprocal at
    # the special-function units' rate, and the grouping (and its sort alone).
    pw_args = (rank_scores, d_rank.label, *rank_grouping)
    b_ms, b_by = bound(28 * d_rank.n_rows, pairs + 10 * differ)
    times["pairwise_grad"] = {
        "ms": time_ms(lambda: pairwise_grad(*pw_args)),
        "back_to_back_ms": back_to_back_ms(lambda: pairwise_grad(*pw_args), launches=20),
        "plain_ms": time_ms(lambda: ref.pairwise_grad_ref(*pw_args), iters=2, warmup=1),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    emit({"phase": "time", "pairwise_grad": {
        "rows": d_rank.n_rows, "queries": RANK_QUERIES, "pairs": pairs,
        "pairs_labels_differ": differ, **times["pairwise_grad"],
        "sfu_bound_ms": 2 * differ / SFU_OPS_PER_S * 1e3,
        "query_groups_ms": time_ms(lambda: ops.query_groups(d_rank.group_ids)),
        "query_groups_back_to_back_ms": back_to_back_ms(
            lambda: ops.query_groups(d_rank.group_ids), launches=20),
        "group_sort_back_to_back_ms": back_to_back_ms(
            lambda: torch.sort(d_rank.group_ids, stable=True), launches=20)}})
    # The same at each of PAIR_GROUPS' shapes (the kernel's launches a call:
    # the query kernel and the spread kernel, counted as one).
    group_times = {}
    for name_p, (sc, lab, grouping) in pair_group_inputs.items():
        g_pairs, g_differ = grouped_pair_counts(lab, grouping)
        args_p = (sc, lab, *grouping)
        g_ms, g_by = bound(28 * sc.shape[0], g_pairs + 10 * g_differ)
        group_times[name_p] = {
            "rows": int(sc.shape[0]), "pairs": g_pairs, "pairs_labels_differ": g_differ,
            "ms": time_ms(lambda: pairwise_grad(*args_p)),
            "back_to_back_ms": back_to_back_ms(lambda: pairwise_grad(*args_p), launches=20),
            "bound_ms": g_ms, "bound_by": g_by,
            "sfu_bound_ms": 2 * g_differ / SFU_OPS_PER_S * 1e3}
    emit({"phase": "time", "pairwise_grad_groups": group_times})
    del pair_group_inputs
    # Each kernel's launches on the path that runs it: the main path's, the
    # ops phase's histogram_packed, the dense default fit's decompress, and
    # the rank fit's pairwise gradient.
    counted = {**launches, "histogram_packed": ops_launches["histogram_packed"],
               "decompress": dense_launches["default"]["decompress"],
               "pairwise_grad": rank_launches["pairwise_grad"]}
    kernels = []
    for name in REPLACES:
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": counted[name],
            "max_abs_err": results[name]["max_abs_err"], **times[name],
        })
    if "jax" in sys.modules or "msgpack" in sys.modules or any(
            m == "repro" or m.startswith("repro.") for m in sys.modules):
        raise SystemExit("the port imported JAX, the JAX package or msgpack")
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
