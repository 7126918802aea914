"""The port's config: defaults held as Python data, merged as the JAX
package merges its YAML layers."""
import os

import pytest
import yaml

from unirec_tpu import config as jax_config
from unirec_tpu_torch import config as torch_config

YAML_DIR = os.path.dirname(jax_config.__file__)


def _yaml(*parts):
    with open(os.path.join(YAML_DIR, *parts)) as f:
        return yaml.safe_load(f)


def test_base_defaults_equal_base_yaml():
    base = _yaml("base.yaml")
    for key, value in torch_config.BASE_DEFAULTS.items():
        assert key in base, key
        assert value == base[key] and type(value) is type(base[key]), key


@pytest.mark.parametrize("model", sorted(torch_config.MODEL_DEFAULTS))
def test_model_defaults_equal_model_yaml(model):
    held = torch_config.MODEL_DEFAULTS[model]
    ref = _yaml("model", f"{model}.yaml")
    assert held == ref
    assert all(type(held[k]) is type(ref[k]) for k in ref)


def test_every_key_the_slice_reads_has_a_default():
    """Keys the serving and training slices read from a freshly parsed
    config (not from a checkpoint) come from the held defaults, as from the
    YAMLs."""
    cfg = torch_config.parse_arguments({"model": "SASRec"}, argv=[], device="cpu")
    ref = jax_config.parse_arguments({"model": "SASRec"}, argv=[])
    for key in ("embedding_size", "n_layers", "n_heads", "inner_size",
                "hidden_act", "layer_norm_eps", "max_seq_len", "init_method",
                "init_std", "init_mean", "use_position_emb", "has_item_bias",
                "has_user_bias", "test_batch_size", "batch_size", "tau",
                "mesh_model", "compute_dtype", "fused_layer", "fused_lastq",
                "use_pallas", "use_fused_ffn", "qkv_packed", "attn_head_stacked",
                # the training slice
                "hidden_dropout_prob", "attn_dropout_prob", "dropout_bits", "epochs",
                "learning_rate", "optimizer", "weight_decay", "grad_clip_value",
                "scheduler", "scheduler_factor", "seed", "auto_resume", "enable_morec",
                "mesh_data", "history_mask_mode", "seq_last", "loss_type", "group_size",
                "ccl_w", "ccl_m", "score_clip_value", "neg_by_pop_alpha",
                "neg_oversample_factor", "neg_membership_pallas",
                "neg_membership_binary_search", "shard_embeddings",
                "vmem_embedding_grad", "embedding_grad_f32", "scan_embedding_grad",
                "expand_embedding_grad"):
        assert cfg[key] == ref[key], key


def test_merge_matches_jax_with_dataset_and_cli(synth_dataset):
    root, _ = synth_dataset
    args = {"model": "SASRec", "dataset_path": root, "n_heads": 2}
    argv = ["--embedding_size", "64", "--hidden_act=gelu", "--last_query_only"]
    cfg = torch_config.parse_arguments(args, argv=argv, device="cpu")
    ref = jax_config.parse_arguments(args, argv=argv)
    for key, value in cfg.items():
        assert ref[key] == value, key
    assert cfg["n_users"] == 201 and cfg["embedding_size"] == 64
    assert cfg["hidden_act"] == "gelu" and cfg["last_query_only"] is True


def test_parse_cmd_arguments_matches_jax():
    argv = ["--a", "1", "--b=2.5", "--c", "[1, 2]", "--flag", "--d", "True",
            "--s", "text", "--e", "1e-10"]
    assert torch_config.parse_cmd_arguments(argv) == \
        jax_config.parse_cmd_arguments(argv)


def test_cuda_defaults_to_bfloat16_unless_set():
    on_card = torch_config.parse_arguments({"model": "SASRec"}, argv=[])
    assert on_card["compute_dtype"] == "bfloat16"
    explicit = torch_config.parse_arguments(
        {"model": "SASRec", "compute_dtype": "float32"}, argv=[])
    assert explicit["compute_dtype"] == "float32"
    repro = torch_config.parse_arguments({"model": "SASRec", "reproducible": 1},
                                         argv=[])
    assert repro["compute_dtype"] == "float32"
    on_cpu = torch_config.parse_arguments({"model": "SASRec"}, argv=[], device="cpu")
    assert on_cpu["compute_dtype"] == "float32"
