"""Faults planted under the ``attention_period`` cells' timed path, for
``test_bench_period.py``: each replaces the port's ``flash_attention``
with a broken copy that takes the ``window`` and ``sinks`` keywords, in
the process that calls it."""

from __future__ import annotations

import math

import torch


def _patch(broken):
    from tpu_operator_torch.workloads import flashattention as fa

    good = fa.flash_attention
    fa.flash_attention = lambda q, k, v, causal=True, window=None, \
        sinks=None: broken(good, q, k, v, causal, window, sinks)


def sink_dropped():
    """Layers with sinks run without them."""
    _patch(lambda good, q, k, v, causal, window, sinks: good(
        q, k, v, causal, window))


def sink_once_per_chunk():
    """The sink enters the denominator once a K/V chunk a row visits,
    not once a row: twice for every row whose window spans two chunks."""
    _patch(lambda good, q, k, v, causal, window, sinks: good(
        q, k, v, causal, window,
        None if sinks is None else sinks + math.log(2.0)))


def values_at_the_key_width():
    """V's rows are read at the key width: each value row starts where it
    would if v were as wide as k, so rows run into their neighbours."""
    def broken(good, q, k, v, causal, window, sinks):
        B, S, hkv, dv = v.shape
        d = k.shape[3]
        if dv == d:
            return good(q, k, v, causal, window, sinks)
        flat = torch.cat([v.reshape(-1),
                          v.new_zeros(B * S * hkv * (d - dv))])
        return good(q, k, flat.view(B, S, hkv, d)[..., :dv], causal,
                    window, sinks)
    _patch(broken)


def full_group_on_window_layers():
    """Window layers read their K/V with the full layers' group: query
    head h reads KV head h // 16 of the first 4, not h // 8 of 8."""
    def broken(good, q, k, v, causal, window, sinks):
        if window is not None:
            k, v = (t[:, :, :t.shape[2] // 2] for t in (k, v))
        return good(q, k, v, causal, window, sinks)
    _patch(broken)
