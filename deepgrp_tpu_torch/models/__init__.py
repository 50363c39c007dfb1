"""Model: the fused recurrence (kernels and plain versions), the attention
and dense head, and model-file IO."""
