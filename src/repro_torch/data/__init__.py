# Seeded synthetic data of the trainers (port of repro/data/synthetic.py).
from .synthetic import image_task

__all__ = ["image_task"]
