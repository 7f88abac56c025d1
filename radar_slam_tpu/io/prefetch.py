"""Double-buffered host->device ingest: upload chunk i+1 while i computes.

SURVEY.md section 2 row 1 prescribes a "prefetch pipeline feeding
HBM-resident batches"; through round 2 every driver did one blocking
``device_put`` of the whole sequence.  For real RadarScenes volumes (a
sequence is minutes of 4-sensor frames) the upload must hide behind
compute instead.

The mechanism is JAX's async dispatch: ``jax.device_put`` returns as soon
as the transfer is *enqueued*, and jitted computation on previously
uploaded chunks runs concurrently with the next chunk's DMA.  The drivers
here carry the sequential ``FrameState`` across chunked ``lax.scan``
programs, so results are bit-identical to the one-shot
``pipeline.frame.process_sequence`` (asserted in
``tests/test_prefetch.py``); ``scripts/bench_prefetch.py`` measures the
overlap.

Replaces the reference's synchronous per-frame loads in
``results/ground_truth_comparison/radarscenes_complete_analysis.py:161-201``
(h5py reads interleaved with compute on the same thread).
"""

from __future__ import annotations

import functools
from typing import Iterator, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from radar_slam_tpu.core.config import PipelineConfig
from radar_slam_tpu.core.types import ScattererBatch
from radar_slam_tpu.pipeline import frame as frame_mod
from radar_slam_tpu.pipeline.frame import FrameOutput, FrameState


def _num_frames(tree) -> int:
    return jax.tree.leaves(tree)[0].shape[0]


def _slice_chunk(tree, start: int, size: int):
    """Host-side chunk [start:start+size], padded by edge-repeat to size."""
    def cut(x):
        c = x[start:start + size]
        if c.shape[0] < size:
            pad = np.repeat(c[-1:], size - c.shape[0], axis=0)
            c = np.concatenate([c, pad], axis=0)
        return c
    return jax.tree.map(cut, tree)


def chunk_uploader(host_tree, chunk: int,
                   device: Optional[jax.Device] = None) -> Iterator:
    """Yield device-resident chunks of a host pytree, each upload enqueued
    one chunk AHEAD of consumption (double buffering)."""
    F = _num_frames(host_tree)
    n = (F + chunk - 1) // chunk
    nxt = jax.device_put(_slice_chunk(host_tree, 0, chunk), device)
    for i in range(n):
        cur = nxt
        if i + 1 < n:
            # Enqueued now; DMA overlaps the caller's compute on `cur`.
            nxt = jax.device_put(_slice_chunk(host_tree, (i + 1) * chunk,
                                              chunk), device)
        yield cur


@functools.partial(jax.jit, static_argnames=("cfg", "rotate_pose"),
                   donate_argnums=(0,))
def _chunk_step(state: FrameState, scatterers: ScattererBatch,
                keys: jax.Array, cfg: PipelineConfig,
                rotate_pose: bool = True
                ) -> Tuple[FrameState, FrameOutput]:
    def step(st, inp):
        sc, k = inp
        return frame_mod.process_scatterers(st, sc, k, cfg, rotate_pose)
    return jax.lax.scan(step, state, (scatterers, keys))


def process_sequence_prefetch(host_scatterers: ScattererBatch,
                              key: jax.Array, cfg: PipelineConfig,
                              chunk: int = 16, rotate_pose: bool = True,
                              device: Optional[jax.Device] = None
                              ) -> FrameOutput:
    """``pipeline.frame.process_sequence`` semantics over HOST-resident
    scatterer batches, with double-buffered chunk uploads.

    The PRNG key splits into the same per-frame key sequence as the
    one-shot driver, and the FrameState carries across chunks, so outputs
    are bit-identical; only the ingest schedule differs (chunk i+1 uploads
    while chunk i computes).
    """
    F = _num_frames(host_scatterers)
    n_pad = ((F + chunk - 1) // chunk) * chunk
    keys = jax.random.split(key, F)          # same sequence as the one-shot
    keys = jnp.concatenate([keys, jnp.repeat(keys[-1:], n_pad - F, axis=0)])
    state = frame_mod.init_state(cfg)
    outs = []
    for i, sc in enumerate(chunk_uploader(host_scatterers, chunk, device)):
        state, out = _chunk_step(state, sc, keys[i * chunk:(i + 1) * chunk],
                                 cfg, rotate_pose)
        outs.append(out)
    full = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *outs)
    return jax.tree.map(lambda x: x[:F], full)


@functools.partial(jax.jit, static_argnames=("cfg", "rig", "rotate_pose"),
                   donate_argnums=(0,))
def _rig_chunk_step(state, scatterers: ScattererBatch, keys: jax.Array,
                    cfg: PipelineConfig, rig, rotate_pose: bool = True):
    from radar_slam_tpu.pipeline import rig as rigmod

    def step(st, inp):
        sc, k = inp
        return rigmod.process_scatterers_rig(st, sc, k, cfg, rig,
                                             rotate_pose)
    return jax.lax.scan(step, state, (scatterers, keys))


def process_sequence_rig_prefetch(host_scatterers: ScattererBatch,
                                  key: jax.Array, cfg: PipelineConfig, rig,
                                  chunk: int = 16, rotate_pose: bool = True,
                                  device: Optional[jax.Device] = None
                                  ) -> FrameOutput:
    """``pipeline.rig.process_sequence_rig`` semantics over HOST-resident
    per-sensor batches [F, B, S] with double-buffered chunk uploads
    (bit-identical; same key split, state carried across chunks)."""
    from radar_slam_tpu.pipeline import rig as rigmod

    F = _num_frames(host_scatterers)
    n_pad = ((F + chunk - 1) // chunk) * chunk
    keys = jax.random.split(key, F)
    keys = jnp.concatenate([keys, jnp.repeat(keys[-1:], n_pad - F, axis=0)])
    state = rigmod.init_rig_state(cfg, rig)
    outs = []
    for i, sc in enumerate(chunk_uploader(host_scatterers, chunk, device)):
        state, out = _rig_chunk_step(state, sc,
                                     keys[i * chunk:(i + 1) * chunk], cfg,
                                     rig, rotate_pose)
        outs.append(out)
    full = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *outs)
    return jax.tree.map(lambda x: x[:F], full)


def process_sequence_rig_batched_prefetch(
        host_scatterers: ScattererBatch, key: jax.Array,
        cfg: PipelineConfig, rig, chunk: int = 32,
        rotate_pose: bool = True,
        device: Optional[jax.Device] = None) -> FrameOutput:
    """``pipeline.rig.process_sequence_rig_batched`` semantics over
    HOST-resident per-sensor batches [F, B, S] with double-buffered chunk
    uploads -- the production ingest path for real RadarScenes rigs
    (VERDICT r04 item 1: through r04 the host-resident route ran the
    sequential scan driver, an order of magnitude below the batched one).

    Phase A (the one-pass kernel over the flattened (chunk x sensor) grid)
    runs per uploaded chunk while the next chunk's DMA is in flight; the
    per-frame features it yields are ~3 KB/frame (vs ~100 KB of
    scatterers), so accumulating them and running ONE whole-sequence
    phase B afterwards reproduces the one-shot batched driver exactly
    (same global key split; smoothing windows see the full sequence).
    """
    from radar_slam_tpu.pipeline import rig as rigmod

    F = _num_frames(host_scatterers)
    n_pad = ((F + chunk - 1) // chunk) * chunk
    keys = jax.random.split(key, F)          # same sequence as the one-shot
    keys = jnp.concatenate([keys, jnp.repeat(keys[-1:], n_pad - F, axis=0)])
    feats = []
    for i, sc in enumerate(chunk_uploader(host_scatterers, chunk, device)):
        feats.append(rigmod._features_from_frame_keys(
            sc, keys[i * chunk:(i + 1) * chunk], cfg, rig))
    full = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *feats)
    full = jax.tree.map(lambda x: x[:F], full)
    return rigmod._rig_sequence_from_features(full, cfg, rig, rotate_pose)


def is_host_resident(tree) -> bool:
    """True when every leaf is host memory (numpy): the case where the
    prefetch drivers can hide the upload behind compute."""
    return all(isinstance(leaf, np.ndarray)
               for leaf in jax.tree.leaves(tree))


@functools.partial(jax.jit, static_argnames=("cfg", "rotate_pose"),
                   donate_argnums=(0,))
def _signal_chunk_step(state: FrameState, signals: jax.Array,
                       cfg: PipelineConfig, rotate_pose: bool = True
                       ) -> Tuple[FrameState, FrameOutput]:
    def step(st, sig):
        return frame_mod.process_signals(st, sig, cfg, rotate_pose)
    return jax.lax.scan(step, state, signals)


def process_signal_sequence_prefetch(host_signals: np.ndarray,
                                     cfg: PipelineConfig, chunk: int = 16,
                                     rotate_pose: bool = True,
                                     device: Optional[jax.Device] = None
                                     ) -> FrameOutput:
    """``process_signal_sequence`` over host ADC cubes [F, A, C, S] with
    double-buffered chunk uploads (the raw-capture replay path)."""
    F = host_signals.shape[0]
    state = frame_mod.init_state(cfg)
    outs = []
    for sig in chunk_uploader(host_signals, chunk, device):
        state, out = _signal_chunk_step(state, sig, cfg, rotate_pose)
        outs.append(out)
    full = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *outs)
    return jax.tree.map(lambda x: x[:F], full)
