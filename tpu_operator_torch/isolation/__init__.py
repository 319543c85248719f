"""Isolated-workload plane: card fencing + fractional vGPUs.

Counterpart of ``tpu_operator/isolation``: vfio-manager -> card fencing
(an advertisement boundary, no vfio-pci rebind), vgpu-device-manager ->
the vGPU manager (fractions under an allocator-enforced memory budget),
sandbox-device-plugin -> the isolated device plugin
(deviceplugin/plugin.py), sandbox-validation -> the fencing/vgpu
validator components (validator/components.py).
"""

from .fencing import (  # noqa: F401
    DEFAULT_FENCING_FILE,
    FencingAgent,
    read_fencing_file,
    resolve_fence_set,
    write_fencing_file,
)
from .vgpu import (  # noqa: F401
    DEFAULT_VGPU_FILE,
    VGPUDeviceManager,
    VGPUProfile,
    build_vgpu_devices,
    load_vgpu_profiles,
    read_vgpu_file,
    write_vgpu_file,
)
