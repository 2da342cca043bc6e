from ompi_tpu_torch.accelerator.framework import (  # noqa: F401
    LOCUS_DEVICE, LOCUS_HOST, SEG_PREFIX, SHM_DIR, Event, IpcBuffer,
    IpcMapping, Stream, accel_framework, check_addr, current_module,
    device_attrs, device_locality, job_tag, select_for_devices,
    tag_for, to_device, to_host, to_numpy,
)
