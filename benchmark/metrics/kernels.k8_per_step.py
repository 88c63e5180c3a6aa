"""kernels.k8_per_step: K8's launches a decode step in the traced window: the `k8_launches` of the window's `*.loop`
spans over the steps their replayed `*.block` spans ran (49 where the GPT-2 step runs K8's add_layer_norm 2 x 24 + 1
times; 0 where it runs the plain chains). A loop with a block that was not replayed (a warm
run before its capture) is left out. Nothing where the loops carry no such count."""

from portbench.spans import in_window


def read(obs):
    spans = in_window(obs)
    loops = {s[0]: s for s in spans if s[2].endswith(".loop") and "k8_launches" in s[5]}
    blocks = {}
    for s in spans:
        if s[2].endswith(".block") and s[1] in loops:
            blocks.setdefault(s[1], []).append(s)
    launches = steps = 0
    for loop, inside in blocks.items():
        if all(b[5].get("event") == "replay" for b in inside):
            launches += int(loops[loop][5]["k8_launches"])
            steps += sum(int(b[5].get("ran", 0)) for b in inside)
    return launches / steps if steps else None
