"""RTMODT port to PyTorch and CUDA (NVIDIA Hopper).

A second package beside the JAX reference ``rtmodt_tpu``: the live pipeline
behind the CLI (threaded reader, per-stage or packed per-frame detect ->
track -> events, renderer, latency profiler) and the chunked, packed-I420
throughput path (YOLOv8 + zone events), with every tracker of the reference
(ByteTrack with greedy or host LAPJV assignment, OC-SORT, DeepSORT and
BoT-SORT with the ROI appearance embedder) and its camera-motion
compensation, and with the reference's one TPU kernel (greedy NMS
suppression) as a hand-written CUDA kernel (``csrc/nms_kernel.cu``).
Imports torch and numpy; never jax, and nothing of ``rtmodt_tpu``.
"""

__version__ = "0.1.0"
