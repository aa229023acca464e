"""Resource banks. SampleBank is the port's own (its import resampling
runs ops/resample.py); FlowwBank and BufferBank are copies of the
reference's, code unchanged."""

from .bufferbank import BufferBank
from .flowwbank import FlowwBank

from .samplebank import Sample, SampleBank, SampleLoadMethod

__all__ = ["Sample", "SampleBank", "SampleLoadMethod", "FlowwBank", "BufferBank"]
