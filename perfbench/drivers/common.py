"""What the generators share: the configuration as a cell runs it."""

from __future__ import annotations

import torch


def _dotted(doc: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in doc.items():
        if isinstance(v, dict):
            out.update(_dotted(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = list(v) if isinstance(v, tuple) else v
    return out


def _text(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (list, tuple)):
        return ",".join(str(x) for x in v)
    return str(v)


def cell_config(cfg_doc: dict, traffic: dict) -> dict:
    """The configuration document's "config" group (a copy) with the
    traffic's "overrides" ({dotted key: value}) applied."""
    def copy(d):
        return {k: copy(v) if isinstance(v, dict) else v
                for k, v in d.items()}

    cfg = copy(cfg_doc["config"])
    for dotted, value in traffic.get("overrides", {}).items():
        *head, leaf = dotted.split(".")
        node = cfg
        for h in head:
            node = node[h]
        if leaf not in node:
            raise KeyError(f"unknown configuration key {dotted!r}")
        node[leaf] = value
    return cfg


def program_config(preset: str, cfg: dict):
    """The program's Config of `preset` with every value of `cfg` set;
    raises unless the program then holds exactly those values."""
    from fashion_nerf_torch.config import config_to_dict, load_config
    want = _dotted(cfg)
    pcfg = load_config(preset, [f"{k}={_text(v)}" for k, v in want.items()
                                if k != "name"])
    got = _dotted(config_to_dict(pcfg))
    diff = sorted(k for k in want if got.get(k) != want[k])
    if diff:
        raise ValueError(f"the program's configuration differs from the "
                         f"document at {diff}")
    return pcfg


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
