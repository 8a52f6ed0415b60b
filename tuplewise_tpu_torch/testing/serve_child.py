"""A line-protocol serving child process for the port's crash tests.

The serving SIGKILL tests and ``chip_smoke.py`` start this program in a
subprocess (``python -c "from tuplewise_tpu_torch.testing.serve_child
import main; main(spec)"``) rather than ``tuplewise-torch serve``: it
takes every ``ServingConfig`` field from one JSON spec, replies with the
count applied and never writes an exit summary. It builds the port's
engine from the spec and reads JSON lines from stdin, one reply line
each, in order:

* ``{"op": "insert", "score": s, "label": b[, "tenant": t]}`` (a score
  and a label, or lists of them) -> ``{"ok": true, "n": events}`` once
  the insert is applied (so it is in the WAL);
* ``{"op": "query"[, "tenant": t]}`` -> ``{"ok": true, "auc_exact": a,
  "tenant": t}`` after every earlier request;
* ``{"op": "tenants"}`` (the fleet) -> ``{"ok": true, "fleet": state}``.

The spec: ``{"config": {ServingConfig fields}, "tenancy": {TenancyConfig
fields} or null}``; a ``tenancy`` block serves the multi-tenant engine.
"""

import json
import sys


def main(spec_json: str) -> None:
    from tuplewise_tpu_torch.serving import (
        MicroBatchEngine, MultiTenantEngine, ServingConfig, TenancyConfig,
    )

    spec = json.loads(spec_json)
    cfg = ServingConfig(**spec["config"])
    fleet = spec.get("tenancy") is not None
    eng = (MultiTenantEngine(cfg, TenancyConfig(**spec["tenancy"]))
           if fleet else MicroBatchEngine(cfg))
    out = sys.stdout
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        req = json.loads(line)
        tenant = req.get("tenant")
        if req["op"] == "insert":
            if fleet:
                n = eng.insert(tenant, req["score"], req["label"]).result(60)
            else:
                n = eng.insert(req["score"], req["label"]).result(60)
            resp = {"ok": True, "n": n}
        elif req["op"] == "tenants":
            eng.flush()
            resp = {"ok": True, "fleet": eng.stats()["fleet"]}
        else:
            if fleet:
                st = eng.query(tenant).result(60)
            else:
                st = eng.query().result(60)
            resp = {"ok": True, "auc_exact": st["auc_exact"],
                    "tenant": tenant}
        out.write(json.dumps(resp) + "\n")
        out.flush()
    eng.close()
