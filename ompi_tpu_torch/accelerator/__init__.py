from ompi_tpu_torch.accelerator.framework import (  # noqa: F401
    LOCUS_DEVICE, LOCUS_HOST, Event, Stream, accel_framework, check_addr,
    current_module, device_locality, select_for_devices, to_device, to_host,
    to_numpy,
)
