from .bpr import BprSamplerData, make_sampler_data, sample_batch

__all__ = ["BprSamplerData", "make_sampler_data", "sample_batch"]
