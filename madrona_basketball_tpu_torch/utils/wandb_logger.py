"""Optional Weights & Biases + TensorBoard logging facade (port of
`madrona_basketball_tpu/utils/wandb_logger.py:13-41`).

`wandb` is imported only if present (it is not a dependency of the
port); the TensorBoard half uses tensorboardX, imported only when a
directory is given.
"""

from __future__ import annotations

from typing import Optional


class WandbLogger:
    def __init__(self, project: str, run_name: str, config: Optional[dict]
                 = None, tensorboard_dir: Optional[str] = None,
                 use_wandb: bool = True):
        self.wandb = None
        if use_wandb:
            try:
                import wandb
                wandb.init(project=project, name=run_name, config=config)
                self.wandb = wandb
            except ImportError:
                print("wandb not available; falling back to TensorBoard only")
        self.writer = None
        if tensorboard_dir:
            from tensorboardX import SummaryWriter
            self.writer = SummaryWriter(tensorboard_dir)

    def log(self, metrics: dict, step: int):
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)
        if self.writer is not None:
            for k, v in metrics.items():
                self.writer.add_scalar(k, v, step)

    def close(self):
        if self.wandb is not None:
            self.wandb.finish()
        if self.writer is not None:
            self.writer.close()
