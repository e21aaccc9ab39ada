"""The port's own copies of the configuration tree and of the asset IO
agree with the reference's: every preset, with and without overrides,
and the committed weights, bitwise."""

import numpy as np
import pytest

from fashion_nerf import assets as jassets
from fashion_nerf import config as jconfig
from fashion_nerf_torch import assets, config

OVERRIDES = (
    [],
    ["train.iters=7", "model.skips=1,3", "render.white_bkgd=false"],
    ["kernels.early_term_eps=0.01", "proposal.block_samples=32",
     "data.frame_ids=", "out_dir=/tmp/x", "model.compute_dtype=float32"],
)


# the port's own presets and fields, which the reference never had: the
# mip-NeRF 360 preset and the model and training fields it needs (its
# optimizer and losses), at their defaults in every shared preset: Adam's
# ε as the reference's optimizer has it, no warm-up, no clipping, no
# Charbonnier ε, no interlevel or distortion loss
PORT_PRESETS = {"mipnerf360"}
PORT_FIELDS = {"model": {"ipe_deg": 0, "bottleneck_width": 256,
                         "view_width": 128},
               "train": {"adam_eps": 1e-8, "lr_delay_steps": 0,
                         "lr_delay_mult": 1.0, "grad_max_norm": 0.0,
                         "charbonnier_eps": 0.0, "interlevel_weight": 0.0,
                         "distortion_weight": 0.0}}


def _on_reference_keys(got: dict, want: dict) -> dict:
    """got restricted to want's keys; its own fields asserted at their
    defaults on the way."""
    for group, fields in PORT_FIELDS.items():
        for k, v in fields.items():
            assert got[group].pop(k) == v, (group, k)
    return got


@pytest.mark.parametrize("ovr", OVERRIDES, ids=["none", "a", "b"])
@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_presets_equal_reference(name, ovr):
    got = config.config_to_dict(config.load_config(name, ovr))
    want = jconfig.config_to_dict(jconfig.load_config(name, ovr))
    assert _on_reference_keys(got, want) == want


def test_preset_names_and_defaults_equal_reference():
    assert sorted(config.PRESETS) == sorted(set(jconfig.PRESETS)
                                            | PORT_PRESETS)
    assert not PORT_PRESETS & set(jconfig.PRESETS)
    want = jconfig.config_to_dict(jconfig.Config())
    assert _on_reference_keys(config.config_to_dict(config.Config()),
                              want) == want


def test_unknown_field_and_preset_raise():
    with pytest.raises(KeyError):
        config.load_config("blender_lego", ["train.nope=1"])
    with pytest.raises(KeyError):
        config.load_config("nope")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


@pytest.mark.parametrize("which", ["flagship", "proposal"])
def test_assets_load_bitwise(which):
    if which == "flagship":
        got, want = assets.load_flagship(), jassets.load_flagship()
        assert assets.FLAGSHIP_CKPT == jassets.FLAGSHIP_CKPT
    else:
        path = f"{assets.ASSETS_DIR}/proposal_synthetic.npz"
        got, want = assets.load_params(path), jassets.load_params(path)
    assert assets.ASSETS_DIR == jassets.ASSETS_DIR
    (gp, gm), (wp, wm) = got, want
    g, w = dict(_leaves(gp)), dict(_leaves(wp))
    assert sorted(g) == sorted(w) and len(g) > 0
    for k in w:
        assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    assert sorted(gm) == sorted(wm)
    for k in wm:
        assert np.array_equal(gm[k], wm[k]), k


def test_flatten_matches_reference():
    tree = {"a": {"b": np.arange(3.0), "c": {"d": np.ones((2, 2))}}}
    got, want = assets._flatten(tree), jassets._flatten(tree)
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert assets.load_flagship("/nonexistent.npz") is None


def test_path_predicates_over_every_knob():
    """The predicates that alone read the path-selection knobs, over every
    setting of `kernels.use_pallas`, `fused_mlp`, `fused_backward`,
    `fused_render` and `blockwise`, with and without a fine pass: the fused
    field for inference needs use_pallas and fused_mlp, for training also
    fused_backward; the blockwise march needs use_pallas and blockwise (what
    asks for it), the fused field and a fine pass; K5 needs use_pallas and
    fused_render."""
    import itertools
    knobs = ("use_pallas", "fused_mlp", "fused_backward", "fused_render",
             "blockwise")
    for values in itertools.product((False, True), repeat=len(knobs)):
        for n_fine in (0, 16):
            on = dict(zip(knobs, values))
            cfg = config.load_config("blender_lego", [
                f"kernels.{k}={str(v).lower()}" for k, v in on.items()]
                + [f"sampling.n_fine={n_fine}"])
            fused = on["use_pallas"] and on["fused_mlp"]
            assert config.takes_fused_field(cfg) == fused
            assert config.takes_fused_field(cfg, training=True) == (
                fused and on["fused_backward"])
            asks = on["use_pallas"] and on["blockwise"]
            assert config.asks_blockwise(cfg) == asks
            assert config.takes_blockwise(cfg) == (asks and fused
                                                   and n_fine > 0)
            assert config.takes_fused_render(cfg) == (
                on["use_pallas"] and on["fused_render"])
