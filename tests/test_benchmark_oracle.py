"""End-to-end oracle gate on THE benchmark scene: the seed-19 1000-torus
CSG scene (Program.fs:67-83) through the full shading pipeline against
the scalar float64 oracle at 64² (fraytracer_tpu/oracle/benchmark.py)."""
from fraytracer_tpu.ops.march import MarchConfig
from fraytracer_tpu.oracle.benchmark import check_benchmark_frame


def test_benchmark_scene_image_allclose_oracle():
    check_benchmark_frame(MarchConfig(bound_skip=True, max_steps=512,
                                      backend="jnp"))
