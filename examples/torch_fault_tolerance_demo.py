"""C4 on the port's session API: kill a crawl process mid-run
(``session.inject_failure``), rebalance its domains (``session.heal``),
keep going; then checkpoint and restore the whole crawl state bit-exactly
(``session.checkpoint``/``session.restore``). The 4 crawl processes are
batched along the state's leading axis of one device.

    PYTHONPATH=src python examples/torch_fault_tolerance_demo.py      # card
    PYTHONPATH=src python examples/torch_fault_tolerance_demo.py --device cpu
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.api import CrawlSession  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402

SHARDS = 4


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_reduced("webparf")
    sess = CrawlSession(cfg, args.device, n_shards=SHARDS)

    r0 = sess.run(12)
    print(f"healthy:            {r0.per_step.mean():.1f} pages/step "
          f"on {sess.n_shards} shards")

    sess.inject_failure(1)
    r1 = sess.run(12)
    print(f"shard 1 dead:       {r1.per_step.mean():.1f} pages/step "
          f"(degraded)")

    sess.heal()
    r2 = sess.run(12)
    print(f"after rebalance:    {r2.per_step.mean():.1f} pages/step "
          f"(dead shard's domains migrated to survivors)")

    # checkpoint/restart the FULL crawl state through the session
    with tempfile.TemporaryDirectory() as d:
        sess.checkpoint(d)
        twin = CrawlSession(cfg, args.device, n_shards=SHARDS).restore(d)
        same = all(torch.equal(a, b) for a, b in zip(sess.state,
                                                     twin.state))
        print(f"checkpoint/restore bit-exact: {same} "
              f"(resumed at step {twin.t})")
        r3 = twin.run(8)
        print(f"resumed crawl:      {r3.per_step.mean():.1f} pages/step")
    return same


if __name__ == "__main__":
    main()
