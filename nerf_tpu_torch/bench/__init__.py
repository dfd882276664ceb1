from nerf_tpu_torch.bench.suite import BenchmarkResult, UnifiedBenchmarkSuite

__all__ = ["BenchmarkResult", "UnifiedBenchmarkSuite"]
