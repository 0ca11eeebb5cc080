"""Host-side utilities of the port: weights, audio IO."""
