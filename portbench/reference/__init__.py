"""The benchmark's plain reference: a frozen copy of the port's
architecture (CroCo ViT-L backbone and stylizer, DPT heads, the Gaussian
adapter, the tile renderer with the plain compositor, the MASt3R teacher,
Regr3D) plus a plain clip + AdamW, in float32 with TF32 off. It imports
nothing of the program: the program may change, this may not. `lowprec`
puts it one precision step below a configuration, as the control."""
