"""Meshes of the port: the process group, live meshes over it, the
production mesh sizes, and the arch- and shape-aware rules.

A live mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over
the default process group (one rank a device); the production mesh of the
dry-run is a plain ``{axis: size}`` mapping, which the sharding rules read
as they read a live mesh's sizes.
"""
from __future__ import annotations

import os
from typing import Dict

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import resolve_device
from repro_torch.configs.base import MeshConfig, ModelConfig
from repro_torch.sharding import ShardingRules, default_rules, mesh_shape


def init_distributed(device="cuda") -> torch.device:
    """Join the default process group (or reuse the one already joined)
    and return this rank's device.

    Under ``torch.distributed.run`` it reads ``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK`` (and the rendezvous address it sets); a process started
    without that environment gets a group of one rank on an in-memory
    store, which needs no port and no network.  NCCL on the card, pinned to
    ``cuda:LOCAL_RANK``; gloo on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dev


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """The dry-run's mesh sizes: one pod ``{"data": 16, "model": 16}``
    (256 devices), several ``{"pod": 2, "data": 16, "model": 16}`` (512)."""
    mc = MeshConfig(multi_pod=multi_pod)
    return dict(zip(mc.axes, mc.shape))


def make_mesh_from_config(mc: MeshConfig) -> DeviceMesh:
    """A live mesh of ``mc``'s shape and axes over the process group."""
    return init_device_mesh(_device_type(), mc.shape, mesh_dim_names=mc.axes)


def make_local_mesh(data: int = 1, model: int = 1) -> DeviceMesh:
    """A ``("data", "model")`` mesh over the process group's ranks; when
    ``data * model`` exceeds the world size, every rank goes on ``data``."""
    n = dist.get_world_size()
    if data * model > n:
        data, model = n, 1
    return init_device_mesh(_device_type(), (data, model),
                            mesh_dim_names=("data", "model"))


def rules_for(cfg: ModelConfig, mesh, shape_kind: str = "train"
              ) -> ShardingRules:
    """Arch- and shape-aware sharding rules (the dry-run's baseline
    policy).

    - kv_heads not divisible by the model axis -> shard the KV cache's
      sequence dim over "model" instead (decode memory would otherwise
      replicate a multi-GB cache 16x).
    - decode / long shapes with a batch smaller than the batch axes ->
      nothing to do: the divisibility fallback replicates.
    """
    shape = mesh_shape(mesh)
    multi_pod = "pod" in shape
    rules = default_rules(multi_pod=multi_pod)
    tp = shape.get("model", 1)
    if shape_kind in ("decode", "prefill"):
        if cfg.num_kv_heads % tp == 0:
            rules = rules.with_overrides(cache_seq=None)
        else:
            rules = rules.with_overrides(cache_seq="model")
    return rules
