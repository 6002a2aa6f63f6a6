from .batching import BatchingRecommender
from .server import make_server, serve_forever
from .service import RecommenderService

__all__ = [
    "BatchingRecommender",
    "RecommenderService",
    "make_server",
    "serve_forever",
]
