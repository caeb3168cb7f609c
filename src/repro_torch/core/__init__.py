"""The Union DSL, skeleton programs and the paper's workloads."""
