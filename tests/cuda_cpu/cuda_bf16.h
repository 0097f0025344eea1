#pragma once
#include "cuda_shim.h"
