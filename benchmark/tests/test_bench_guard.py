"""The check on loaded modules compares top-level names whole."""

from benchmark.harness.guard import forbidden_loaded


def test_refuses_jax_and_the_jax_package():
    assert forbidden_loaded(["jax", "numpy"]) == ["jax"]
    assert forbidden_loaded(["jaxlib.xla_client", "flax.linen"]) == ["flax", "jaxlib"]
    assert forbidden_loaded(["mg_gcn_tpu.models.gcn"]) == ["mg_gcn_tpu"]


def test_accepts_the_port():
    assert forbidden_loaded(["mg_gcn_tpu_torch", "mg_gcn_tpu_torch.parallel.dist", "jaxtyping", "benchmark"]) == []
