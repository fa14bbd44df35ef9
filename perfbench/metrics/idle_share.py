"""The device's idle share in the traced stretch: 1 - (the union of its
kernel and copy intervals) / the stretch's wall time. One reader for the
quantity, which ``BENCHMARK.json`` declares once per end-to-end metric it
moves (``idle_share.decode``, ``.train``, ``.serve``)."""

from perfbench.harness.trace import idle_share as read  # noqa: F401
