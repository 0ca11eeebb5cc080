"""Run logging: a JSONL file per run.

The port's copy of audio_algebra_tpu/utils/logging.py's RunLogger, without
the wandb forwarding: `runs/<project>/<name>/log.jsonl` holds one record
per `log` call, and `config.json` the run's configuration. The media of
the effects trainer's demos go to files beside it, each logged by its
path: `log_audio` (WAV), `log_image` (PNG, or an array's .npy where
matplotlib is missing), `log_table` (CSV) and `log_point_cloud` (.npy, and
beside it the interactive HTML of utils/viz.point_cloud_html, as JAX's).
"""
from __future__ import annotations

import csv
import json
import time
from pathlib import Path
from typing import Optional

import numpy as np


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

    def _media_path(self, name: str, step: int, suffix: str) -> Path:
        return self.dir / f"{name.replace('/', '_')}_{step:08d}{suffix}"

    def log_audio(self, name: str, audio, sample_rate: int, step: int = 0) -> str:
        """Save audio (clipped to [-1, 1]) as a WAV and log its path."""
        from .audio_io import save_audio

        path = str(self._media_path(name, step, ".wav"))
        save_audio(path, np.clip(np.asarray(audio), -1, 1), sample_rate)
        self.log({name: path}, step=step)
        return path

    def log_image(self, name: str, image, step: int = 0) -> Optional[str]:
        """Log an image file's path, or render an (H, W[, C]) array to PNG
        first (None when it could not be rendered)."""
        path = image if isinstance(image, str) else None
        if path is None:
            from .viz import save_image
            path = save_image(np.asarray(image), str(self._media_path(name, step, ".png")))
        self.log({name: path}, step=step)
        return path

    def log_table(self, name: str, columns, rows, step: int = 0) -> str:
        """Write a table as CSV and log its path."""
        path = self._media_path(name, step, ".csv")
        with open(path, "w", newline="") as f:
            wr = csv.writer(f)
            wr.writerow(columns)
            wr.writerows(rows)
        self.log({name: str(path)}, step=step)
        return str(path)

    def log_point_cloud(self, name: str, points, step: int = 0) -> str:
        """Save an (N, 3..6) point cloud as .npy, with its interactive HTML
        twin (same stem, .html) where it has 3 or more columns, and log the
        .npy's path."""
        from .viz import point_cloud_html

        pts = np.asarray(points)
        path = self._media_path(name, step, ".npy")
        np.save(path, pts)
        if pts.ndim == 2 and pts.shape[1] >= 3:
            point_cloud_html(pts, title=name, path=str(path.with_suffix(".html")))
        self.log({name: str(path)}, step=step)
        return str(path)

    def push_config(self, args) -> None:
        cfg = args if isinstance(args, dict) else \
            args.to_dict() if hasattr(args, "to_dict") else vars(args)
        with open(self.dir / "config.json", "w") as f:
            json.dump(cfg, f, indent=2, default=str)

    def finish(self) -> None:
        self._fh.close()
