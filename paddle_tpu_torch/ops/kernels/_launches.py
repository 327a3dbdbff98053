"""Launch accounting shared by the kernel wrappers."""


def count_launch(wrapper, dtype) -> None:
    """One launch of ``wrapper``'s kernel: its ``.launches`` count, and
    the count of its ``dtype`` instance in ``.dtype_launches``. Wrappers
    call it where they launch, and nowhere else."""
    wrapper.launches += 1
    wrapper.dtype_launches[dtype] = wrapper.dtype_launches.get(dtype, 0) + 1
