"""Built-in rule modules; importing this package registers all of them."""

from . import (  # noqa: F401
    control_purity,
    donated_buffer,
    epoch_pin,
    host_sync,
    hot_loop,
    jit_cache,
    kernel_parity,
    plan_publish,
    private_reach_in,
    single_writer,
    transfer_accounting,
    waivers,
)
