"""In-memory scenes: sampled ray batches and procedural ground truth."""
