"""Analytics workloads as vertex programs."""
