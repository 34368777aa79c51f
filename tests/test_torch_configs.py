"""Port of the model configs (``repro.configs``): ``get`` and ``reduced`` for
every architecture compare field for field with the reference's dataclasses,
derived properties included."""
import dataclasses

import pytest

from repro import configs as rconfigs
from repro_torch import configs

ARCHS = list(rconfigs.ARCH_NAMES)
PROPS = ("head_dim", "padded_vocab", "n_periods", "slab_tokens", "group")


def _fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    out.update({p: getattr(cfg, p) for p in PROPS})
    out["param_counts"] = cfg.param_counts()
    out["moe_layers"] = [cfg.is_moe_layer(i) for i in range(len(cfg.layout))]
    return out


def test_registry_names_match():
    assert configs.ARCH_NAMES == rconfigs.ARCH_NAMES
    assert len(configs.ARCH_NAMES) == 10


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("which", ["get", "reduced"])
def test_config_matches_reference_field_for_field(arch, which):
    ours = getattr(configs, which)(arch)
    theirs = getattr(rconfigs, which)(arch)
    assert type(ours).__name__ == type(theirs).__name__
    assert _fields(ours) == _fields(theirs)


@pytest.mark.parametrize("over", [dict(cache_b0=8), dict(cache_b0=4, attention_impl="pallas",
                                                          paged_attend_impl="pallas", cache_slab=16)])
def test_reduced_overrides_match_reference(over):
    assert _fields(configs.reduced("qwen2.5-3b", **over)) == _fields(rconfigs.reduced("qwen2.5-3b", **over))


def test_shapes_and_validation_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in rconfigs.SHAPES.items()}
    for arch in ARCHS:
        assert configs.sub_quadratic_ready(configs.get(arch)) == rconfigs.sub_quadratic_ready(rconfigs.get(arch))
    with pytest.raises(ValueError):
        configs.reduced("qwen2.5-3b", n_layers=3, layout=("attn", "attn"))
    with pytest.raises(ValueError):
        configs.get("gpt-2")
