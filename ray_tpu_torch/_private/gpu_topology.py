"""GPU discovery for the node daemon.

Takes the place of ``ray_tpu``'s TPU topology discovery (and of the
reference's GPU autodetect, ``_private/resource_spec.py``).  It counts the
cards without importing torch and without creating a CUDA context, so the
daemon never holds a card:

* ``RT_NUM_GPUS`` overrides everything (fake GPUs for tests, as
  ``RT_NUM_TPU_CHIPS`` does for the JAX package);
* else ``CUDA_VISIBLE_DEVICES``, when set, names the cards (an empty value
  means none);
* else ``nvidia-smi`` (NVML: no CUDA context either) lists them, where it
  is installed;
* else every ``/dev/nvidia<N>`` device file is a card.  The device files
  can name more cards than the process may open (a container may show
  another tenant's node), which is why nvidia-smi comes first.

A node with cards advertises ``GPU: n`` and ``accelerator_type:<model>``
(``NVIDIA H100 80GB HBM3`` gives ``H100``, as the reference names it).  The
model comes from the driver's ``/proc/driver/nvidia/gpus/*/information``,
else from nvidia-smi.
"""

from __future__ import annotations

import glob
import os
import re
import shutil
import subprocess
from typing import Dict, List, Optional, Tuple

_INFO_GLOB = "/proc/driver/nvidia/gpus/*/information"


def _nvidia_smi() -> Optional[List[Tuple[str, str]]]:
    """(index, name) of each card nvidia-smi lists; None without it."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    out = subprocess.run(
        [smi, "--query-gpu=index,name", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [tuple(part.strip() for part in line.split(",", 1))
            for line in out.splitlines() if line.strip()]


def _proc_model() -> Optional[str]:
    for path in sorted(glob.glob(_INFO_GLOB)):
        with open(path) as f:
            for line in f:
                key, _, value = line.partition(":")
                if key.strip() == "Model" and value.strip():
                    return value.strip()
    return None


def _accelerator_type(name: str) -> str:
    return name.strip().removeprefix("NVIDIA ").strip().split()[0]


def detect() -> Tuple[List[str], Dict[str, float]]:
    """The ids a worker's ``CUDA_VISIBLE_DEVICES`` may name on this node,
    and the resources the node advertises for them."""
    fake = os.environ.get("RT_NUM_GPUS")
    if fake is not None:
        ids = [str(i) for i in range(int(fake))]
        return ids, ({"GPU": float(len(ids))} if ids else {})
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None and not visible.strip():
        return [], {}
    smi = _nvidia_smi()
    if visible is not None:
        ids = [v.strip() for v in visible.split(",") if v.strip()]
    elif smi is not None:
        ids = [index for index, _ in smi]
    else:
        ids = [str(i) for i in range(len(
            [d for d in glob.glob("/dev/nvidia*")
             if re.fullmatch(r"/dev/nvidia\d+", d)]))]
    if not ids:
        return [], {}
    res = {"GPU": float(len(ids))}
    model = _proc_model() or (smi[0][1] if smi else None)
    if model:
        res[f"accelerator_type:{_accelerator_type(model)}"] = 1.0
    return ids, res
