"""PML — point-to-point messaging layer (mirrors ``ompi/mca/pml``)."""
