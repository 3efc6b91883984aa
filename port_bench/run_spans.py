"""A traced run of one cell that also reads the program's own spans.

    python3 port_bench/run_spans.py --workload CELL --seed N --seconds S

from the root of a checkout.  Runs the cell as ``run.py ... --trace 1``
does, and prints the same result line last on standard output, but reads
the profiled slice as a :class:`port_bench.spans.SpanTimeline`: the line's
breakdown puts each idle gap down to the innermost range of either prefix
(``bench.*`` or ``tsod.*``), and one more line on standard error,
``port_bench spans: {...}``, holds the readings of
:data:`port_bench.spans.READERS` that find their spans, the synchronising
runtime calls of the slice by name and, in a served cell, the images a
second of the slice's requests.  On a program without spans the readings
are empty and the breakdown is ``run.py``'s.
"""

import collections
import json
import os
import sys
import tempfile


def main(argv) -> int:
    from port_bench import harness, runner, spans

    class SpanRun(runner.Run):
        """A run whose slice is read as a ``SpanTimeline``; its span
        readings are kept on the class (``harness.main`` owns the run)."""

        readings = None

        def read_slice(self):
            if self._prof is None:
                return
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                self.timeline = spans.SpanTimeline(path)
            finally:
                os.unlink(path)
            self._prof = None

        def per_layer(self, ctx) -> dict:
            out = super().per_layer(ctx)
            tl = self.timeline
            found = {}
            for name, read in spans.READERS.items():
                v = read(ctx)
                if v is not None:
                    found[name] = float(v)
            calls = tl.ranges_named(r"bench\.predict:\d+$")
            SpanRun.readings = {
                "readings": found,
                "syncs_by_call": dict(collections.Counter(
                    n for _, n in tl.syncs)),
                "spans": len(tl.spans)}
            if calls:
                SpanRun.readings["slice_img_per_s"] = (
                    sum(int(r[2].split(":")[1]) for r in calls)
                    / ((calls[-1][1] - calls[0][0]) * 1e-6))
            return out

        def breakdown(self):
            out = super().breakdown()
            if out is not None:
                out["idle_gaps"] = self.timeline.idle_gaps_by_span()
            return out

    # harness.main builds its run from port_bench.runner.Run
    runner.Run = SpanRun
    rc = harness.main([*argv, "--trace", "1"],
                      harness.process_start_time())
    if SpanRun.readings is not None:
        print("port_bench spans: " + json.dumps(SpanRun.readings),
              file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main(sys.argv[1:]))
