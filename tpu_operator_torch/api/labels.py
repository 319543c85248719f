"""Well-known resource names of the port.

Counterpart of ``tpu_operator/api/labels.py``, which names the TPU
resource ``google.com/tpu`` (``TPU_RESOURCE``). The NVIDIA device plugin
advertises cards as ``nvidia.com/gpu``. The node labels, annotations and
paths of the reference are ported with the control-plane surfaces.
"""

GPU_RESOURCE = "nvidia.com/gpu"
