"""Driver: composes a source + operator chain into a batch stream.

Reference role: operator/Driver.java:371 (processInternal) — but where the
reference pulls pages operator-by-operator under a time-sliced executor, here
each operator is a generator transform and every device step is queued on
the device's stream; the host thread just keeps the feed full.

Port of trino_tpu/runtime/driver.py: a copy, with the package renamed.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Sequence

from trino_tpu_torch.columnar import Batch


class Driver:
    def __init__(self, source: Iterable[Batch], operators: Sequence = ()):
        self.source = source
        self.operators = list(operators)

    def run(self) -> Iterator[Batch]:
        from trino_tpu_torch.runtime.lifecycle import check_current

        stream: Iterable[Batch] = self.source
        for op in self.operators:
            stream = op.process(stream)

        def guarded(s: Iterable[Batch]) -> Iterator[Batch]:
            # cooperative cancellation per batch: a canceled/expired query
            # aborts between pages instead of draining the whole chain
            for b in s:
                check_current()
                yield b

        return guarded(stream)

    def collect(self) -> list[Batch]:
        return list(self.run())

    def rows(self) -> list[list]:
        out = []
        for b in self.collect():
            out.extend(b.to_pylist())
        return out
