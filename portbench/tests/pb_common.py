"""A small configuration and mix for the benchmark's CPU tests: the full
model's widths on a 32 m crop, a window of 4, 4096 points a scan, the UNet
capacities large enough that no site is dropped."""

from __future__ import annotations

import dataclasses
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def small_config(fixed: bool, score_thresh: float = 0.0105):
    import torch

    from insmos_tpu_torch.config import Config

    torch.set_num_threads(max(1, min(4, (os.cpu_count() or 2) // 2)))
    base = Config()
    mn = dataclasses.replace(
        base.model.motionnet, crop_range=(-16.0, -16.0, -4.0, 16.0, 16.0, 4.8),
        site_capacities=(32768, 16384, 8192, 4096), stem_scan_capacity=16384,
        decoder_capacities=(32768, 16384, 8192))
    return dataclasses.replace(
        base,
        data=dataclasses.replace(
            base.data, point_cloud_range=(-12.8, -12.8, -3.0, 12.8, 12.8, 1.0)),
        model=dataclasses.replace(
            base.model, n_past_steps=4, max_voxels=8192,
            unet_capacities=(8192, 32768, 16384, 8192, 8192),
            unet_site_capacity=8192, motionnet=mn,
            post=dataclasses.replace(base.model.post,
                                     score_thresh=score_thresh)),
        runtime=dataclasses.replace(base.runtime, max_points_per_scan=4096,
                                    compute_dtype="float32",
                                    incremental_stem=fixed))


def config_doc(cfg, limits=None) -> dict:
    doc = {"config": json.loads(json.dumps(cfg.to_dict()))}
    if limits is not None:
        doc["check"] = {"limits": limits}
    return doc


def mix(name: str = "drive", mixes_dir: str | None = None, **kw) -> dict:
    from portbench.run import load_mix

    m = load_mix(name, mixes_dir)
    m.update(dict(warm_steps=5, compare=2, profile_steps=1, max_steps=40,
                  ahead=4))
    m.update(kw)
    return m


def near_scan(stream, w: int, n: int = 4096, reach: float = 15.0):
    """Step w's scan cut to the points within ``reach`` m of the sensor
    (the small crop), at most n."""
    s, tf = stream.next()
    keep = (abs(s[:, 0]) < reach) & (abs(s[:, 1]) < reach)
    return s[keep][:n], tf
