from vision_assist_tpu_torch.planning.dedup import deduplicate_paths, path_similarity

__all__ = ["deduplicate_paths", "path_similarity"]
