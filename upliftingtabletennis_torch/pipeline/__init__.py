from upliftingtabletennis_torch.pipeline.interface import BallDetector, TableDetector

__all__ = ["BallDetector", "TableDetector"]
