"""The paged KV pool's gather (``KVBlockPool.gather``): device ms a step
in the traced slice.  The gather copies each paged leaf (K and V of each
KV stack) as 8-byte words with PyTorch's indexing kernel, in two launches a
leaf where the copy passes 2^31 bytes; the kernel's name with its word
type is fixed from the first trace (NVIDIA H100, PyTorch 2.11).  The only
other launch of that name in a step is the write's block-table lookup
(``KVBlockPool.scatter_token``), ~2 us a step, which the sum includes."""

from pbcore import trace
from pbcore.readers import slice_steps

KERNEL = "index_kernel_impl<at::native::OpaqueType<8> >"


def read(rec):
    if rec.trace is None:
        return None
    ns, launches = trace.kernel_ns(rec.trace, [KERNEL])
    if not launches:
        return None
    return ns / 1e6 / slice_steps(rec)
