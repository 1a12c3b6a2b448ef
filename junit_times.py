"""Serial seconds per test file from a pytest junit XML report.

    python3 junit_times.py REPORT.xml   # the file pytest's --junitxml wrote

Prints one line per file, the slowest first: its summed case times
(a module fixture's time lands on the first case that uses it) and its
case count, then the total and the total over the tier-1 command's 6
workers. Under ``--dist loadfile`` a file runs whole on one worker, so its
sum is the least wall time it holds that worker.
"""

import collections
import sys
import xml.etree.ElementTree as ET

#: The tier-1 command's ``-n``.
WORKERS = 6


def file_times(path: str) -> tuple[collections.Counter, collections.Counter]:
    """(seconds, cases) per test module of the report."""
    seconds, cases = collections.Counter(), collections.Counter()
    for case in ET.parse(path).getroot().iter("testcase"):
        parts = case.get("classname", "").split(".")
        name = parts[1] if parts[0] == "tests" and len(parts) > 1 else parts[0]
        seconds[name] += float(case.get("time", 0.0))
        cases[name] += 1
    return seconds, cases


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    seconds, cases = file_times(argv[0])
    for name, s in seconds.most_common():
        print(f"{name:40s} {s:10.3f} {cases[name]:5d}")
    total = sum(seconds.values())
    print(f"total {total:.3f} s, {total / WORKERS:.3f} s per worker over {WORKERS}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
