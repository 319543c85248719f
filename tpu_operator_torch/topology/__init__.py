"""Card groups behind the device plugin (the mig-manager slot)."""

from .manager import (  # noqa: F401
    DEFAULT_SLICE_FILE,
    Profile,
    TopologyManager,
    chip_groups,
    load_profiles,
    read_slice_file,
    write_slice_file,
)
