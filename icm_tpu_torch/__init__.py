"""icm_tpu_torch: the PyTorch/CUDA port of icm_tpu for an NVIDIA H100.

A second package beside the JAX reference ``icm_tpu``; it imports
nothing of it. Entry points run on the CUDA card unless the caller asks
for the CPU (``device="cpu"``), where every kernel's plain PyTorch version
runs instead. See ``models.create_model``, ``models.CharmCodec`` (the
host wire) and ``models.DeviceWireCodec`` (the device wire).
"""

__version__ = "0.1.0"
