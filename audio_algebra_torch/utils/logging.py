"""Run logging: a JSONL file per run.

The port's copy of audio_algebra_tpu/utils/logging.py's RunLogger, without
the wandb forwarding and the media helpers of the effects trainers:
`runs/<project>/<name>/log.jsonl` holds one record per `log` call, and
`config.json` the run's configuration.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional


class RunLogger:
    def __init__(self, project: str, name: Optional[str] = None, out_dir: str = "runs",
                 config: Optional[dict] = None):
        self.project = project
        self.name = name or time.strftime("%Y%m%d-%H%M%S")
        self.dir = Path(out_dir) / project / self.name
        self.dir.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.dir / "log.jsonl", "a")
        self._step = 0
        if config:
            self.push_config(config)

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        step = self._step if step is None else step
        rec = {"step": step, "ts": time.time()}
        rec.update({k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v)
                    for k, v in metrics.items()})
        self._fh.write(json.dumps(rec, default=str) + "\n")
        self._fh.flush()
        self._step = step + 1

    def push_config(self, args) -> None:
        cfg = args if isinstance(args, dict) else \
            args.to_dict() if hasattr(args, "to_dict") else vars(args)
        with open(self.dir / "config.json", "w") as f:
            json.dump(cfg, f, indent=2, default=str)

    def finish(self) -> None:
        self._fh.close()
