from ray_tpu_torch.dashboard.http_server import DashboardHttpServer

__all__ = ["DashboardHttpServer"]
