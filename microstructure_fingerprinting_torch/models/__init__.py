"""Model API and bucket fit steps."""
