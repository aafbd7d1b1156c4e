"""Find a cell, its configuration and its traffic by name.

A cell is trackbench/workloads/<cell>.json: {"config": <name>, "traffic":
<name>, "warmup_frames", "samples", "sample_frames", "profiled_frames",
"limits"}.  A configuration is trackbench/configs/<config>.json, with the
tracker's settings under "tracker" and the image size under "image"; a
traffic mix is trackbench/traffic/<traffic>.json, the parameters of one
generator (trackbench/traffic.py).  Adding any of them adds a file.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))


class Cell(NamedTuple):
    name: str
    cell: dict
    config: dict
    traffic: dict


def _load(kind: str, name: str) -> dict:
    path = os.path.join(ROOT, kind, f"{name}.json")
    if not os.path.isfile(path):
        raise SystemExit(f"trackbench: no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, overrides: dict | None = None) -> Cell:
    """The cell `name` with its configuration and traffic; `overrides`
    (tests only) updates the cell, the configuration's tracker settings and
    image, and the traffic, each key by key."""
    cell = _load("workloads", name)
    config = _load("configs", cell["config"])
    traffic = _load("traffic", cell["traffic"])
    for part, doc in (("cell", cell), ("traffic", traffic), ("image", config["image"])):
        doc.update((overrides or {}).get(part, {}))
    for group, values in (overrides or {}).get("tracker", {}).items():
        config["tracker"][group] = {**config["tracker"][group], **values}
    return Cell(name, cell, config, traffic)


def weights_path(config: dict) -> str:
    """The configuration's frozen weights file, refused unless its SHA-256
    is the one the configuration records (`lfnet_weights_sha256`)."""
    path = os.path.join(ROOT, config["lfnet_weights"])
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != config["lfnet_weights_sha256"]:
        raise SystemExit(f"trackbench: {path} has SHA-256 {digest}, not the configuration's "
                         f"{config['lfnet_weights_sha256']}")
    return path
