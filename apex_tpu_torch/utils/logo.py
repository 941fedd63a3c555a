"""Console banner, as the JAX package's `utils/logo.py` prints it
(reference util/logo.py:8-22 prints an ASCII logo + version line)."""

LOGO = r"""
      _     _____  _____ __  __          _____ ____  _   _
     / \   |  _  \| ____|\ \/ /         |_   _|  _ \| | | |
    / _ \  | |_) )|  _|   \  /   _____    | | | |_) ) | | |
   / ___ \ |  __/ | |___  /  \  |_____|   | | |  __/| |_| |
  /_/   \_\|_|    |_____|/_/\_\           |_| |_|    \___/
"""


def print_logo(subtitle: str = ""):
    print("\033[92m" + LOGO + "\033[0m")
    print("  apex_tpu: on-device deep RL for bipedal locomotion")
    if subtitle:
        print(f"  {subtitle}")
    print()
