from vision_assist_tpu_torch.io.scenarios import load_scenario, scenario_names

__all__ = ["load_scenario", "scenario_names"]
